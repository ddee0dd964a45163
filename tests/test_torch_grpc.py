"""The port's KServe gRPC frontend held to the reference's.

- The port's protobuf codec (dynamo_tpu_torch/llm/grpc/kserve.py) and the
  reference's protoc classes (kserve_pb2, on google.protobuf) parse each
  other's bytes for every message of protos/kserve.proto, with maps,
  oneofs, packed scalars, raw contents and unknown fields; a message
  without maps serializes to the same bytes.
- A stock grpcio client (grpc.aio with kserve_pb2's serializers) sends the
  same calls to the port's server (its own HTTP/2, runtime/http2.py) and to
  the reference's KserveGrpcService, each over its own package's runtime
  and EchoEngine: equal replies for all six RPCs, streaming, status codes
  and messages, tensor models (typed, raw, a 1 MiB raw tensor through the
  flow-control windows), deadlines, and a cancellation mid-stream that
  frees the engine request.
- The port's client (GrpcChannel) against the reference's server.
"""

import asyncio

import grpc
import numpy as np
import pytest

from dynamo_tpu.llm import EchoEngine as JEcho
from dynamo_tpu.llm import ModelDeploymentCard as JCard
from dynamo_tpu.llm import ModelManager as JManager
from dynamo_tpu.llm import ModelWatcher as JWatcher
from dynamo_tpu.llm import register_llm as jregister
from dynamo_tpu.llm.grpc import KserveGrpcService as JService
from dynamo_tpu.llm.grpc import kserve_pb2 as pb
from dynamo_tpu.llm.grpc.service import SERVICE_NAME
from dynamo_tpu.llm.protocols import tensor as jtensor
from dynamo_tpu.runtime import DistributedRuntime as JRuntime
from dynamo_tpu.runtime import InProcEventPlane as JPlane
from dynamo_tpu.runtime import MemKVStore as JStore
from dynamo_tpu.runtime import RuntimeConfig as JConfig
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.engines import EchoEngine
from dynamo_tpu_torch.llm.grpc import KserveGrpcService
from dynamo_tpu_torch.llm.grpc import kserve as kp
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols import tensor as ttensor
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.runtime import http2
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.discovery.store import MemKVStore
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

RPCS = {
    "ServerLive": (pb.ServerLiveRequest, pb.ServerLiveResponse),
    "ServerReady": (pb.ServerReadyRequest, pb.ServerReadyResponse),
    "ModelReady": (pb.ModelReadyRequest, pb.ModelReadyResponse),
    "ModelMetadata": (pb.ModelMetadataRequest, pb.ModelMetadataResponse),
    "ModelInfer": (pb.ModelInferRequest, pb.ModelInferResponse),
}


# ---------------------------------------------------------------- the codec
def _infer_request(rng) -> "pb.ModelInferRequest":
    r = pb.ModelInferRequest(model_name="m", model_version="2", id=f"id{rng.integers(99)}")
    r.parameters["max_tokens"].int64_param = int(rng.integers(-2**63, 2**63 - 1))
    r.parameters["temperature"].double_param = float(rng.normal())
    r.parameters["ignore_eos"].bool_param = False        # a oneof at its default
    r.parameters["note"].string_param = "né中"
    r.parameters[""].string_param = ""
    for k in range(int(rng.integers(1, 4))):
        t = r.inputs.add()
        t.name, t.datatype = f"in{k}", "FP32"
        t.shape.extend(int(v) for v in rng.integers(-3, 5, 3))
        t.parameters["p"].int64_param = int(rng.integers(-5, 5))
        c = t.contents
        c.bool_contents.extend(bool(v) for v in rng.integers(0, 2, 3))
        c.int_contents.extend(int(v) for v in rng.integers(-2**31, 2**31 - 1, 4))
        c.int64_contents.extend(int(v) for v in rng.integers(-2**63, 2**63 - 1, 2))
        c.uint_contents.extend(int(v) for v in rng.integers(0, 2**32 - 1, 2))
        c.uint64_contents.extend([2**64 - 1, 0, int(rng.integers(0, 2**62))])
        c.fp32_contents.extend(np.float32(rng.normal(size=3)).tolist())
        c.fp64_contents.extend(rng.normal(size=2).tolist())
        c.bytes_contents.extend([b"", bytes(rng.integers(0, 256, 9, dtype=np.uint8))])
    o = r.outputs.add(name="out")
    o.parameters["binary_data"].bool_param = True
    r.raw_input_contents.extend([b"\x00\x01", bytes(300)])
    return r


def _messages(rng):
    md = pb.ModelMetadataResponse(name="m", versions=["1", "2"], platform="p")
    i = md.inputs.add(name="text_input", datatype="BYTES")
    i.shape.extend([1, -1])
    md.outputs.add(name="o", datatype="FP16")
    resp = pb.ModelInferResponse(model_name="m", model_version="1", id="x")
    resp.parameters["finish_reason"].string_param = "stop"
    out = resp.outputs.add(name="text_output", datatype="BYTES")
    out.shape.append(1)
    out.contents.bytes_contents.append("héllo".encode())
    resp.raw_output_contents.append(bytes(range(256)))
    return [
        pb.ServerLiveRequest(), pb.ServerLiveResponse(live=True), pb.ServerReadyRequest(),
        pb.ServerReadyResponse(ready=True), pb.ModelReadyRequest(name="m", version="3"),
        pb.ModelReadyResponse(ready=False), pb.ModelMetadataRequest(name="ä", version=""),
        md, pb.InferParameter(double_param=-0.0), pb.InferParameter(int64_param=0),
        pb.InferTensorContents(int_contents=[-1], fp32_contents=[1.5]),
        _infer_request(rng), resp, pb.ModelStreamInferResponse(error_message="boom"),
        pb.ModelStreamInferResponse(infer_response=resp),
    ]


MESSAGES = _messages(np.random.default_rng(0))


def _has_map(msg) -> bool:
    return type(msg).__name__ in ("ModelInferRequest", "ModelInferResponse",
                                  "ModelStreamInferResponse") and bool(msg.ByteSize())


@pytest.mark.parametrize("i", range(len(MESSAGES)),
                         ids=[f"{type(m).__name__}{i}" for i, m in enumerate(MESSAGES)])
def test_the_codec_and_kserve_pb2_parse_each_other(i):
    msg = MESSAGES[i]
    cls = kp.MESSAGES[type(msg).__name__]
    wire = msg.SerializeToString()
    mine = cls.FromString(wire)
    again = mine.SerializeToString()
    assert type(msg).FromString(again) == msg
    assert cls.FromString(again) == mine
    if not _has_map(msg):
        # python protobuf writes fields in number order: the same bytes
        assert again == wire


@pytest.mark.parametrize("seed", range(6))
def test_seeded_infer_requests_round_trip(seed):
    msg = _infer_request(np.random.default_rng(100 + seed))
    mine = kp.ModelInferRequest.FromString(msg.SerializeToString())
    assert pb.ModelInferRequest.FromString(mine.SerializeToString()) == msg
    assert mine.parameters["note"].string_param == "né中"
    assert mine.parameters["ignore_eos"].WhichOneof("parameter_choice") == "bool_param"
    assert list(mine.inputs[0].contents.uint64_contents)[:2] == [2**64 - 1, 0]


def test_unpacked_repeated_scalars_and_unknown_fields_are_read():
    # field 3 (int64 shape) written unpacked, then unknown fields of every
    # wire type
    wire = (b"\x0a\x01a" + b"\x18\x05\x18\x7f" + b"\xa0\x06\x01" + b"\xaa\x06\x02hi"
            + b"\xb5\x06\x00\x00\x00\x00" + b"\xb9\x06" + bytes(8))
    m = kp.TensorMetadata.FromString(wire)
    assert (m.name, list(m.shape)) == ("a", [5, 127])
    assert m == kp.TensorMetadata.FromString(
        pb.ModelMetadataResponse.TensorMetadata.FromString(wire).SerializeToString())
    with pytest.raises(kp.DecodeError):
        kp.TensorMetadata.FromString(b"\x0a\x05ab")
    assert kp.zigzag_decode(kp.zigzag_encode(-3)) == -3 and kp.zigzag_encode(-1) == 1


# ---------------------------------------------------------------- the stacks
class DoublerTensorEngine:
    """A generic tensor worker: doubles numeric inputs, echoes BYTES inputs,
    fails on an input named "bad"."""

    def __init__(self, tensor_mod):
        self.m = tensor_mod

    async def generate(self, request, context):
        treq = self.m.TensorRequest.from_obj(request)
        outs = []
        for t in treq.tensors:
            if t.name == "bad":
                yield self.m.TensorResponse(error="bad input").to_obj()
                return
            if t.datatype == "BYTES":
                outs.append(self.m.Tensor.from_bytes_list(t.name + "_echo", t.to_bytes_list(),
                                                          t.shape))
            else:
                outs.append(self.m.Tensor.from_numpy(t.name + "_x2", t.to_numpy() * 2))
        yield self.m.TensorResponse(tensors=outs).to_obj()


async def _wait_models(manager, names):
    for _ in range(200):
        if all(manager.get(n) and manager.get(n).client.instances for n in names):
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"models {names} never appeared")


async def _reference_stack(delay_s):
    store = JStore()
    cfg = JConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    rts = [await JRuntime(cfg, store=store, event_plane=JPlane()).start() for _ in range(2)]
    served = [
        await jregister(rts[0], JEcho(delay_s=delay_s), JCard(
            name="echo-model", tokenizer="byte", context_length=64,
            model_type=["chat", "completions"])),
        await jregister(rts[0], DoublerTensorEngine(jtensor), JCard(
            name="tensor-model", tokenizer="byte", context_length=16, model_type=["tensor"],
            endpoint="tensor"), raw_token_stream=True),
    ]
    manager = JManager()
    watcher = await JWatcher(rts[1], manager).start()
    await _wait_models(manager, ["echo-model", "tensor-model"])
    svc = JService(manager, host="127.0.0.1", port=0)
    addr = await svc.start()
    return addr, (svc, watcher, served, rts)


async def _port_stack(delay_s):
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    rts = [await DistributedRuntime(cfg, store=store).start() for _ in range(2)]
    served = [
        await register_llm(rts[0], EchoEngine(delay_s=delay_s), ModelDeploymentCard(
            name="echo-model", tokenizer="byte", context_length=64,
            model_type=["chat", "completions"])),
        await register_llm(rts[0], DoublerTensorEngine(ttensor), ModelDeploymentCard(
            name="tensor-model", tokenizer="byte", context_length=16, model_type=["tensor"],
            endpoint="tensor"), raw_token_stream=True),
    ]
    manager = ModelManager()
    watcher = await ModelWatcher(rts[1], manager).start()
    await _wait_models(manager, ["echo-model", "tensor-model"])
    svc = KserveGrpcService(manager, host="127.0.0.1", port=0)
    await svc.start()
    return f"127.0.0.1:{svc.port}", (svc, watcher, served, rts)


async def _stop(handles):
    svc, watcher, served, rts = handles
    await svc.stop()
    await watcher.stop()
    for s in served:
        await s.stop()
    for rt in rts:
        await rt.shutdown()


async def _both(fn, delay_s=0.0):
    """``fn(addr, served)`` against each server; {name: result}."""
    out = {}
    for name, start in (("port", _port_stack), ("reference", _reference_stack)):
        addr, handles = await start(delay_s)
        try:
            out[name] = await fn(addr, handles[2])
        finally:
            await _stop(handles)
    return out


def _text_request(text, max_tokens=None, **params):
    r = pb.ModelInferRequest(model_name="echo-model", id="req-1")
    t = r.inputs.add(name="text_input", datatype="BYTES")
    t.shape.append(1)
    t.contents.bytes_contents.append(text.encode())
    if max_tokens is not None:
        r.parameters["max_tokens"].int64_param = max_tokens
    for k, v in params.items():
        setattr(r.parameters[k], {bool: "bool_param", float: "double_param",
                                  int: "int64_param"}[type(v)], v)
    return r


def _stub(ch):
    calls = {n: ch.unary_unary(f"/{SERVICE_NAME}/{n}", request_serializer=a.SerializeToString,
                               response_deserializer=b.FromString)
             for n, (a, b) in RPCS.items()}
    calls["ModelStreamInfer"] = ch.unary_stream(
        f"/{SERVICE_NAME}/ModelStreamInfer",
        request_serializer=pb.ModelInferRequest.SerializeToString,
        response_deserializer=pb.ModelStreamInferResponse.FromString)
    return calls


async def _outcome(coro):
    try:
        return "ok", await coro
    except grpc.aio.AioRpcError as e:
        return "error", (e.code(), e.details())


# ---------------------------------------------------------------- the RPCs
CALLS = [
    ("ServerLive", pb.ServerLiveRequest()),
    ("ServerReady", pb.ServerReadyRequest()),
    ("ModelReady", pb.ModelReadyRequest(name="echo-model")),
    ("ModelReady", pb.ModelReadyRequest(name="nope")),
    ("ModelMetadata", pb.ModelMetadataRequest(name="echo-model")),
    ("ModelMetadata", pb.ModelMetadataRequest(name="nope")),
    ("ModelInfer", _text_request("kserve!", max_tokens=5)),
    ("ModelInfer", _text_request("kserve!")),
    ("ModelInfer", _text_request("tempered", max_tokens=3, temperature=0.0,
                                 ignore_eos=True)),
    ("ModelInfer", pb.ModelInferRequest(model_name="nope")),
    ("ModelInfer", _text_request("x" * 70)),                        # over the context
    ("ModelInfer", pb.ModelInferRequest(model_name="echo-model", inputs=[
        pb.ModelInferRequest.InferInputTensor(
            name="input_ids", datatype="INT64", shape=[3],
            contents=pb.InferTensorContents(int64_contents=[104, 105, 33]))])),
    ("ModelInfer", pb.ModelInferRequest(model_name="echo-model", inputs=[
        pb.ModelInferRequest.InferInputTensor(
            name="input_ids", datatype="INT64", shape=[80],
            contents=pb.InferTensorContents(int64_contents=[7] * 80))])),
]


@pytest.mark.parametrize("k", range(len(CALLS)), ids=[f"{c[0]}{i}" for i, c in enumerate(CALLS)])
async def test_a_grpcio_client_gets_the_reference_servers_replies(k):
    name, request = CALLS[k]

    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            return await _outcome(_stub(ch)[name](request))

    out = await _both(run)
    assert out["port"] == out["reference"]


async def _streamed(call):
    items = []
    try:
        async for item in call:
            items.append(item)
    except grpc.aio.AioRpcError as e:
        return items, (e.code(), e.details())
    return items, None


@pytest.mark.parametrize("request_", [
    _text_request("stream me", 9), _text_request("abc"),
    pb.ModelInferRequest(model_name="nope"), _text_request("y" * 70)],
    ids=["max_tokens", "to_eos", "not_found", "too_long"])
async def test_model_stream_infer_streams_as_the_reference(request_):
    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            return await _streamed(_stub(ch)["ModelStreamInfer"](request_))

    out = await _both(run)
    assert out["port"] == out["reference"]


def _tensor_request(**inputs):
    r = pb.ModelInferRequest(model_name="tensor-model", id="t")
    for name, (dt, shape, field, values) in inputs.items():
        t = r.inputs.add(name=name, datatype=dt)
        t.shape.extend(shape)
        if field == "raw":
            r.raw_input_contents.append(values)
        else:
            getattr(t.contents, field).extend(values)
    return r


TENSOR_CALLS = [
    _tensor_request(x=("FP32", [2, 2], "fp32_contents", [1.0, 2.0, 3.0, 4.0])),
    _tensor_request(v=("INT64", [3], "raw", np.array([1, -2, 3], np.int64).tobytes()),
                    h=("FP16", [2], "raw", np.array([0.5, -1], np.float16).tobytes())),
    _tensor_request(s=("BYTES", [2], "bytes_contents", [b"ab", b""])),
    _tensor_request(u=("UINT8", [3], "uint_contents", [1, 2, 255])),
    _tensor_request(big=("FP32", [512, 512], "raw",
                         np.random.default_rng(1).normal(size=(512, 512)).astype(
                             np.float32).tobytes())),
    _tensor_request(v=("INT64", [4], "raw", b"\x00" * 8)),          # wrong size
    _tensor_request(q=("COMPLEX", [1], "fp32_contents", [1.0])),    # unknown datatype
    _tensor_request(bad=("FP32", [1], "fp32_contents", [1.0])),     # the worker fails
]


@pytest.mark.parametrize("k", range(len(TENSOR_CALLS)))
async def test_tensor_models_are_served_as_the_reference(k):
    request = TENSOR_CALLS[k]

    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            stub = _stub(ch)
            unary = await _outcome(stub["ModelInfer"](request))
            streamed = await _streamed(stub["ModelStreamInfer"](request))
            return unary, streamed

    out = await _both(run)
    assert out["port"] == out["reference"]


async def test_unknown_methods_and_deadlines_give_the_reference_codes():
    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            missing = ch.unary_unary(f"/{SERVICE_NAME}/Nope",
                                     request_serializer=pb.ServerLiveRequest.SerializeToString,
                                     response_deserializer=pb.ServerLiveResponse.FromString)
            unknown = await _outcome(missing(pb.ServerLiveRequest()))
            slow = await _outcome(_stub(ch)["ModelInfer"](_text_request("a" * 40), timeout=0.2))
            return unknown, slow[0], slow[1][0]

    out = await _both(run, delay_s=0.05)
    assert out["port"] == out["reference"]
    assert out["port"][0][1][0] == grpc.StatusCode.UNIMPLEMENTED
    assert out["port"][2] == grpc.StatusCode.DEADLINE_EXCEEDED


async def test_a_stream_cancelled_mid_way_frees_the_engine_request():
    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            call = _stub(ch)["ModelStreamInfer"](_text_request("z" * 60, 60))
            got = 0
            async for _ in call:
                got += 1
                if got == 3:
                    call.cancel()
                    break
            # the worker's request plane sees the cancel and its engine
            # stream stops: nothing stays in flight
            for _ in range(100):
                if served[0].server.inflight == 0:
                    break
                await asyncio.sleep(0.02)
            return got, served[0].server.inflight

    out = await _both(run, delay_s=0.02)
    assert out["port"] == out["reference"] == (3, 0)


async def test_the_port_client_against_the_reference_server():
    addr, handles = await _reference_stack(0.0)
    chan = http2.GrpcChannel(addr)
    try:
        infer = chan.unary_unary(f"/{SERVICE_NAME}/ModelInfer",
                                 kp.ModelInferRequest.SerializeToString,
                                 kp.ModelInferResponse.FromString)
        stream = chan.unary_stream(f"/{SERVICE_NAME}/ModelStreamInfer",
                                   kp.ModelInferRequest.SerializeToString,
                                   kp.ModelStreamInferResponse.FromString)
        req = kp.ModelInferRequest.FromString(_text_request("from the port", 6).SerializeToString())
        reply = await infer(req)
        async with grpc.aio.insecure_channel(addr) as ch:
            want = await _stub(ch)["ModelInfer"](_text_request("from the port", 6))
        assert pb.ModelInferResponse.FromString(reply.SerializeToString()) == want
        items = [i async for i in stream(req)]
        text = b"".join(i.infer_response.outputs[0].contents.bytes_contents[0] for i in items)
        assert text == want.outputs[0].contents.bytes_contents[0]
        with pytest.raises(http2.GrpcError) as e:
            await infer(kp.ModelInferRequest(model_name="nope"))
        assert e.value.code() == http2.StatusCode.NOT_FOUND
        assert e.value.details() == "model 'nope' not found"
        big = kp.ModelInferRequest.FromString(TENSOR_CALLS[4].SerializeToString())
        reply = await infer(big)
        got = np.frombuffer(reply.raw_output_contents[0], np.float32)
        want = np.frombuffer(TENSOR_CALLS[4].raw_input_contents[0], np.float32) * 2
        np.testing.assert_array_equal(got, want)
    finally:
        await chan.close()
        await _stop(handles)


def test_grpc_message_percent_encoding():
    for text in ("plain", "100% sure", "naïve\nline", ""):
        enc = http2.percent_encode(text)
        assert all(0x20 <= ord(c) <= 0x7E for c in enc)
        assert http2.percent_decode(enc) == text
    assert http2.parse_timeout("250m") == 0.25 and http2.parse_timeout("2S") == 2.0
    assert http2.parse_timeout("x") is None


# ---------------------------------------------------------------- HPACK, HTTP/2
def test_hpack_decodes_the_rfc_7541_huffman_requests():
    """RFC 7541 C.4.1-C.4.3: one decoder across three requests (Huffman
    strings, the dynamic table carried from block to block)."""
    from dynamo_tpu_torch.runtime import hpack

    d = hpack.Decoder()
    assert d.decode(bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff")) == [
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com")]
    assert d.decode(bytes.fromhex("828684be5886a8eb10649cbf"))[-1] == ("cache-control",
                                                                       "no-cache")
    assert d.decode(bytes.fromhex("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf")) == [
        (":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]
    assert d.table == [("custom-key", "custom-value"), ("cache-control", "no-cache"),
                       (":authority", "www.example.com")]
    assert d.size == 164


def test_hpack_integers_eviction_and_size_updates():
    from dynamo_tpu_torch.runtime import hpack

    # RFC 7541 C.1
    assert hpack.encode_int(10, 5) == b"\x0a"
    assert hpack.encode_int(1337, 5) == b"\x1f\x9a\x0a"
    assert hpack.encode_int(42, 8) == b"\x2a"
    assert hpack._int(b"\x1f\x9a\x0a", 0, 5) == (1337, 3)
    d = hpack.Decoder(max_table_size=100)

    def literal(name, value):   # literal with incremental indexing, new name
        return (b"\x40" + hpack.encode_int(len(name), 7) + name.encode()
                + hpack.encode_int(len(value), 7) + value.encode())

    d.decode(literal("a" * 10, "b" * 20) + literal("c" * 10, "d" * 20))  # 62 + 62 > 100
    assert d.table == [("c" * 10, "d" * 20)] and d.size == 62
    assert d.decode(b"\xbe") == [("c" * 10, "d" * 20)]          # index 62: dynamic
    d.decode(b"\x20")                                          # size update to 0
    assert d.table == [] and d.size == 0
    with pytest.raises(hpack.HpackError):
        d.decode(b"\xbe")
    with pytest.raises(hpack.HpackError):
        hpack.Decoder(64).decode(b"\x3f\xe1\x1f")                # 4096 > the limit
    with pytest.raises(hpack.HpackError):
        hpack.huffman_decode(b"\xff\xff\xff\xff")                 # EOS in the string
    block = hpack.encode([(":status", "200"), ("grpc-message", "é%")])
    assert hpack.Decoder().decode(block) == [(":status", "200"), ("grpc-message", "é%")]


async def _raw_frames(reader, until):
    """(type, flags, stream, payload) frames until ``until(frame)``."""
    import struct as _struct

    out = []
    while True:
        head = await asyncio.wait_for(reader.readexactly(9), 10)
        n = int.from_bytes(head[:3], "big")
        frame = (head[3], head[4], _struct.unpack(">I", head[5:])[0] & 0x7FFFFFFF,
                 await reader.readexactly(n) if n else b"")
        out.append(frame)
        if until(frame):
            return out


async def test_the_http2_server_keeps_the_protocol_with_a_raw_peer():
    """A peer that speaks raw frames: a PING gets its ACK, a header block
    split over CONTINUATION decodes, and a 200 KB reply waits for the
    peer's WINDOW_UPDATE past the default 65535-byte windows."""
    import struct as _struct

    from dynamo_tpu_torch.runtime import hpack

    async def echo(request, context):
        return request * 2

    server = http2.GrpcServer("127.0.0.1", 0)
    server.add_unary("/t.S/Echo", echo, lambda b: b, lambda b: b)
    port = await server.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        def frame(t, flags, sid, payload=b""):
            writer.write(len(payload).to_bytes(3, "big") + bytes([t, flags])
                         + _struct.pack(">I", sid) + payload)

        writer.write(http2.PREFACE)
        frame(http2.SETTINGS, 0, 0)
        frame(http2.PING, 0, 0, b"pingpong")
        got = await _raw_frames(reader, lambda f: f[0] == http2.PING)
        assert got[-1] == (http2.PING, http2.ACK, 0, b"pingpong")
        assert got[0][0] == http2.SETTINGS
        block = hpack.encode([(":method", "POST"), (":scheme", "http"), (":path", "/t.S/Echo"),
                              (":authority", "x"), ("content-type", "application/grpc"),
                              ("te", "trailers"), ("x-pad", "p" * 300)])
        frame(http2.HEADERS, 0, 1, block[:50])
        frame(http2.CONTINUATION, 0, 1, block[50:200])
        frame(http2.CONTINUATION, http2.END_HEADERS, 1, block[200:])
        body = http2.frame_message(b"z" * 100_000)
        for i in range(0, len(body), 16384):
            frame(http2.DATA, http2.END_STREAM if i + 16384 >= len(body) else 0, 1,
                  body[i:i + 16384])
        await writer.drain()
        # the reply stops at the default window until the peer credits it
        first = await _raw_frames(reader, lambda f: f[0] == http2.DATA)
        sent = sum(len(f[3]) for f in first if f[0] == http2.DATA)
        await asyncio.sleep(0.3)
        while True:
            try:
                more = await asyncio.wait_for(_raw_frames(reader, lambda f: True), 0.3)
            except asyncio.TimeoutError:
                break
            sent += sum(len(f[3]) for f in more if f[0] == http2.DATA)
        assert sent == 65535
        frame(http2.WINDOW_UPDATE, 0, 0, _struct.pack(">I", 1 << 20))
        frame(http2.WINDOW_UPDATE, 0, 1, _struct.pack(">I", 1 << 20))
        await writer.drain()
        rest = await _raw_frames(reader, lambda f: f[0] == http2.HEADERS and f[1] & 1)
        sent += sum(len(f[3]) for f in rest if f[0] == http2.DATA)
        assert sent == 5 + 200_000
        trailers = dict(hpack.Decoder().decode(rest[-1][3]))
        assert trailers["grpc-status"] == "0"
    finally:
        writer.close()
        await server.stop()


# ---------------------------------------------------------------- the bounds
@pytest.mark.parametrize("rpc", ["ModelInfer", "ModelStreamInfer"])
async def test_a_message_over_grpcios_receive_limit_gets_the_reference_status(rpc):
    """A 5 MiB ModelInfer: grpcio's server refuses a message over its
    default 4 MiB receive limit with RESOURCE_EXHAUSTED; the port's server
    gives the same code and words, and serves the next call on the same
    channel."""
    big = _text_request("x" * (5 << 20))

    async def run(addr, served):
        async with grpc.aio.insecure_channel(addr) as ch:
            stub = _stub(ch)
            got = (await _outcome(stub[rpc](big)) if rpc == "ModelInfer"
                   else await _streamed(stub[rpc](big)))
            after = await _outcome(stub["ModelInfer"](_text_request("kserve!", max_tokens=5)))
            return got, after

    out = await _both(run)
    assert out["port"] == out["reference"]
    code, details = out["port"][0][1]
    assert code == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert "larger than max" in details
    assert out["port"][1][0] == "ok"


async def _raw_peer(on_stream=None):
    """A server-side H2Connection on a local port and a raw client socket
    past the preface and both SETTINGS."""
    import struct as _struct

    conns = []

    async def accept(reader, writer):
        conns.append(await http2.H2Connection(reader, writer, client=False,
                                              on_stream=on_stream).start())

    server = await asyncio.start_server(accept, "127.0.0.1", 0)
    reader, writer = await asyncio.open_connection(
        "127.0.0.1", server.sockets[0].getsockname()[1])

    def frame(t, flags, sid, payload=b""):
        writer.write(len(payload).to_bytes(3, "big") + bytes([t, flags])
                     + _struct.pack(">I", sid) + payload)

    writer.write(http2.PREFACE)
    frame(http2.SETTINGS, 0, 0)
    got = await _raw_frames(reader, lambda f: f[0] == http2.SETTINGS and f[1] & http2.ACK)
    settings = dict(_struct.unpack(">HI", got[0][3][i:i + 6])
                    for i in range(0, len(got[0][3]), 6))
    return server, conns, reader, writer, frame, settings


def _request_block(**extra):
    from dynamo_tpu_torch.runtime import hpack

    return hpack.encode([(":method", "POST"), (":scheme", "http"), (":path", "/t.S/M"),
                         (":authority", "x"), ("content-type", "application/grpc"),
                         *extra.items()])


async def _goaway(reader) -> int:
    import struct as _struct

    got = await _raw_frames(reader, lambda f: f[0] == http2.GOAWAY)
    return _struct.unpack(">II", got[-1][3][:8])[1]


async def test_the_http2_side_bounds_frames_header_blocks_and_header_lists():
    """The advertised SETTINGS carry the header list limit; a header list
    over it resets its stream with ENHANCE_YOUR_CALM and the connection
    goes on; a CONTINUATION flood past MAX_HEADER_BLOCK bytes, and a frame
    over MAX_FRAME_SIZE, each end their connection with GOAWAY."""
    import struct as _struct

    opened = []
    server, conns, reader, writer, frame, settings = await _raw_peer(opened.append)
    try:
        assert settings[http2.S_MAX_HEADER_LIST_SIZE] == http2.MAX_HEADER_LIST_SIZE
        assert settings[http2.S_MAX_CONCURRENT_STREAMS] == http2.MAX_CONCURRENT_STREAMS
        block = _request_block(**{"x-big": "v" * http2.MAX_HEADER_LIST_SIZE})
        frame(http2.HEADERS, 0, 1, block[:http2.MAX_FRAME_SIZE])
        frame(http2.CONTINUATION, http2.END_HEADERS, 1, block[http2.MAX_FRAME_SIZE:])
        got = await _raw_frames(reader, lambda f: f[0] == http2.RST_STREAM)
        assert got[-1][2] == 1
        assert _struct.unpack(">I", got[-1][3])[0] == http2.ENHANCE_YOUR_CALM
        frame(http2.HEADERS, http2.END_HEADERS, 3, _request_block())
        await writer.drain()
        for _ in range(100):
            if opened:
                break
            await asyncio.sleep(0.01)
        assert [st.id for st in opened] == [3]
        # a CONTINUATION flood: fragments that never end the block
        frame(http2.HEADERS, 0, 5, _request_block()[:10])
        for _ in range(http2.MAX_HEADER_BLOCK // 8192 + 2):
            frame(http2.CONTINUATION, 0, 5, b"\x00" * 8192)
        await writer.drain()
        assert await _goaway(reader) == http2.ENHANCE_YOUR_CALM
        assert conns[0].closed.is_set()
    finally:
        writer.close()
        server.close()
    server, conns, reader, writer, frame, _ = await _raw_peer()
    try:
        frame(http2.PING, 0, 0, b"\x00" * (http2.MAX_FRAME_SIZE + 1))
        await writer.drain()
        assert await _goaway(reader) == http2.FRAME_SIZE_ERROR
    finally:
        writer.close()
        server.close()


async def test_received_data_is_credited_only_as_the_reader_takes_it():
    """DATA that no reader has taken is not credited back: the peer's
    windows close after LOCAL_WINDOW bytes, data past them is a
    FLOW_CONTROL_ERROR, and the stream's reader taking the data sends the
    WINDOW_UPDATEs for exactly the bytes it took."""
    import struct as _struct

    opened = []
    server, conns, reader, writer, frame, _ = await _raw_peer(opened.append)
    try:
        frame(http2.HEADERS, http2.END_HEADERS, 1, _request_block())
        chunk = b"d" * http2.MAX_FRAME_SIZE
        for _ in range(8):
            frame(http2.DATA, 0, 1, chunk)
        frame(http2.PING, 0, 0, b"12345678")
        await writer.drain()
        got = await _raw_frames(reader, lambda f: f[0] == http2.PING)
        assert not [f for f in got if f[0] == http2.WINDOW_UPDATE]
        st = opened[0]
        assert st.recv_window == http2.LOCAL_WINDOW - 8 * len(chunk)
        taken = 0
        while taken < 3 * len(chunk):
            kind, data, _ = await st.next_event()
            taken += len(data) if kind == "data" else 0
        frame(http2.PING, 0, 0, b"abcdefgh")
        await writer.drain()
        got = await _raw_frames(reader, lambda f: f[0] == http2.PING)
        credit = {0: 0, 1: 0}
        for f in got:
            if f[0] == http2.WINDOW_UPDATE:
                credit[f[2]] += _struct.unpack(">I", f[3])[0]
        assert credit == {0: taken, 1: taken}
        # past the connection's window: nothing was taken of these
        left = http2.LOCAL_WINDOW - 8 * len(chunk) + taken
        for _ in range(left // len(chunk) + 1):
            frame(http2.DATA, 0, 1, chunk)
        await writer.drain()
        assert await _goaway(reader) == http2.FLOW_CONTROL_ERROR
    finally:
        writer.close()
        server.close()
