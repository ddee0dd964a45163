"""HTTPS on the port's frontend (an ``ssl.SSLContext`` on its own HTTP
server), held to its plain twin and to the reference's HTTPS frontend,
and the port's processes with this slice's planes together: a ``tiny-vl``
worker on the HTTP request plane (``DTPU_REQUEST_PLANE=http``) behind a
frontend serving HTTPS (the committed localhost pair, tests/data/) and
KServe gRPC (``--grpc-port 0``), answering an image chat, a gRPC
completion equal to its HTTPS twin, and ``POST /clear_kv_blocks``."""

import asyncio
import base64
import json
import os
import signal
import ssl
import subprocess
import sys
import time

import pytest

from dynamo_tpu_torch.runtime.http_client import HttpClient

from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CERT = os.path.join(DATA, "tls_localhost.crt")
KEY = os.path.join(DATA, "tls_localhost.key")


def _client_ctx() -> ssl.SSLContext:
    return ssl.create_default_context(cafile=CERT)


def _completion(text, n):
    return json.dumps({"model": "echo-model", "prompt": text, "max_tokens": n,
                       "temperature": 0}).encode()


def _strip(body: dict) -> dict:
    return {k: v for k, v in body.items() if k not in ("id", "created")}


# how long a stack may take to see its model (discovery catching up, the
# service answering), under the test runner's parallel load
READY_S = 30.0


async def _echo_stack(service_cls, manager_cls, watcher_cls, register, card_cls, echo_cls,
                      runtime_parts, **svc_kw):
    rt_cls, cfg_cls, store_cls = runtime_parts
    store = store_cls()
    cfg = cfg_cls(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    rts = [await rt_cls(cfg, store=store).start() for _ in range(2)]
    served = await register(rts[0], echo_cls(), card_cls(name="echo-model", tokenizer="byte",
                                                         context_length=512))
    manager = manager_cls()
    watcher = await watcher_cls(rts[1], manager).start()
    deadline = time.monotonic() + READY_S
    while not (manager.get("echo-model") and manager.get("echo-model").client.instances):
        if time.monotonic() > deadline:
            raise AssertionError(f"{service_cls.__module__}: echo-model's instance not "
                                 f"discovered in {READY_S} s")
        await asyncio.sleep(0.02)
    svc = service_cls(manager, host="127.0.0.1", port=0, **svc_kw)
    await svc.start()
    return svc, (watcher, served, rts)


async def _ready(port, scheme, ctx=None):
    """Wait until the stack's service answers /v1/models with the model."""
    http = HttpClient(ssl=ctx)
    deadline = time.monotonic() + READY_S
    last = None
    try:
        while time.monotonic() < deadline:
            try:
                r = await http.request("GET", f"{scheme}://localhost:{port}/v1/models")
                last = (r.status, json.loads(await r.read()))
                if r.status == 200 and [m["id"] for m in last[1].get("data", [])] == [
                        "echo-model"]:
                    return
            except OSError as e:
                last = repr(e)
            await asyncio.sleep(0.05)
    finally:
        await http.close()
    raise AssertionError(f"{scheme} service on {port} not ready in {READY_S} s: {last}")


async def _stop(svc, handles):
    watcher, served, rts = handles
    await svc.stop()
    await watcher.stop()
    await served.stop()
    for rt in rts:
        await rt.shutdown()


async def _exchange(port, scheme, ctx=None):
    http = HttpClient(ssl=ctx)
    try:
        out = []
        for path, body in (("/health", None), ("/v1/models", None),
                           ("/v1/completions", _completion("over tls", 6))):
            r = await http.request("POST" if body else "GET",
                                   f"{scheme}://localhost:{port}{path}", body,
                                   {"Content-Type": "application/json"})
            out.append((r.status, _strip(json.loads(await r.read()))))
        return out
    finally:
        await http.close()


async def test_https_serves_what_plain_and_the_reference_serve():
    from dynamo_tpu import llm as J
    from dynamo_tpu import runtime as JR
    from dynamo_tpu.llm.http.service import HttpService as JService
    from dynamo_tpu_torch import runtime as TR
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.engines import EchoEngine
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.serve import register_llm

    port_parts = (HttpService, ModelManager, ModelWatcher, register_llm,
                  ModelDeploymentCard, EchoEngine,
                  (TR.DistributedRuntime, TR.RuntimeConfig, TR.MemKVStore))
    ref_parts = (JService, J.ModelManager, J.ModelWatcher, J.register_llm,
                 J.ModelDeploymentCard, J.EchoEngine,
                 (JR.DistributedRuntime, JR.RuntimeConfig, JR.MemKVStore))
    got = {}
    for name, parts, tls in (("port_https", port_parts, True), ("port_plain", port_parts, False),
                             ("ref_https", ref_parts, True)):
        kw = dict(tls_cert=CERT, tls_key=KEY) if tls else {}
        svc, handles = await _echo_stack(*parts, **kw)
        try:
            scheme, ctx = ("https", _client_ctx()) if tls else ("http", None)
            await _ready(svc.port, scheme, ctx)
            got[name] = await _exchange(svc.port, scheme, ctx)
            if tls:
                # a plain-text client is refused by the TLS listener
                with pytest.raises(Exception):
                    await _exchange(svc.port, "http")
        finally:
            await _stop(svc, handles)
    assert got["port_https"] == got["port_plain"] == got["ref_https"]
    assert got["port_https"][2][0] == 200


def test_tls_flags_are_given_together():
    from dynamo_tpu_torch.frontend.__main__ import parse_args
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http.service import HttpService

    with pytest.raises(SystemExit):
        parse_args(["--tls-cert-path", CERT])
    args = parse_args(["--tls-cert-path", CERT, "--tls-key-path", KEY, "--grpc-port", "0"])
    assert (args.tls_cert_path, args.tls_key_path, args.grpc_port) == (CERT, KEY, 0)
    assert parse_args([]).grpc_port == -1
    with pytest.raises(ValueError, match="together"):
        HttpService(ModelManager(), tls_cert=CERT)


def _wait_line(proc, prefix, timeout=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")


def test_the_processes_serve_images_grpc_https_and_clears(tmp_path):
    from dynamo_tpu_torch.llm.grpc import kserve as kp
    from dynamo_tpu_torch.runtime import http2

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []

    def start(*args, extra_env=None):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path),
                             env={**env, **(extra_env or {})}, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    try:
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        worker = start("dynamo_tpu_torch.engine", *common, "--preset", "tiny-vl",
                       "--model", "vl", "--device", "cpu", "--max-context", "256",
                       "--num-blocks", "64", "--decode-steps", "1",
                       extra_env={"DTPU_REQUEST_PLANE": "http"})
        front = start("dynamo_tpu_torch.frontend", *common, "--host", "127.0.0.1",
                      "--port", "0", "--grpc-port", "0", "--tls-cert-path", CERT,
                      "--tls-key-path", KEY)
        port = int(_wait_line(front, "TORCH_FRONTEND_READY").rsplit(":", 1)[1])
        grpc_port = int(_wait_line(front, "KSERVE_GRPC_READY").split()[1])
        _wait_line(worker, "TORCH_ENGINE_READY")
        png = open(os.path.join(DATA, "vision_fixture.png"), "rb").read()
        image = f"data:image/png;base64,{base64.b64encode(png).decode()}"

        async def main():
            base = f"https://localhost:{port}"
            http = HttpClient(ssl=_client_ctx())
            chan = http2.GrpcChannel(f"127.0.0.1:{grpc_port}")
            try:
                for _ in range(300):
                    r = await http.request("GET", base + "/v1/models")
                    if json.loads(await r.read())["data"]:
                        break
                    await asyncio.sleep(0.05)
                chat = {"model": "vl", "max_tokens": 5, "temperature": 0, "messages": [
                    {"role": "user", "content": [
                        {"type": "text", "text": "what is it?"},
                        {"type": "image_url", "image_url": {"url": image}}]}]}
                r = await http.request("POST", base + "/v1/chat/completions",
                                       json.dumps(chat).encode(),
                                       {"Content-Type": "application/json"})
                body = json.loads(await r.read())
                assert r.status == 200, body
                assert body["usage"]["prompt_tokens"] > 4     # the placeholder run
                r = await http.request("POST", base + "/v1/completions",
                                       json.dumps({"model": "vl", "prompt": "hello grpc " * 6,
                                                   "max_tokens": 6,
                                                   "temperature": 0}).encode(),
                                       {"Content-Type": "application/json"})
                text = json.loads(await r.read())["choices"][0]["text"]
                req = kp.ModelInferRequest(model_name="vl", id="g1")
                t = req.inputs.add(name="text_input", datatype="BYTES")
                t.shape.append(1)
                t.contents.bytes_contents.append(b"hello grpc " * 6)
                req.parameters["max_tokens"].int64_param = 6
                req.parameters["temperature"].double_param = 0.0
                infer = chan.unary_unary("/inference.GRPCInferenceService/ModelInfer",
                                         kp.ModelInferRequest.SerializeToString,
                                         kp.ModelInferResponse.FromString)
                reply = await infer(req)
                assert reply.outputs[0].contents.bytes_contents[0].decode() == text
                r = await http.request("POST", base + "/clear_kv_blocks",
                                       b'{"levels": ["g1"]}',
                                       {"Content-Type": "application/json"})
                cleared = json.loads(await r.read())["cleared"]["vl"]
                (result,) = cleared.values()
                assert result["g1"] > 0 and result["snapshot"]["cached_blocks"] == 0
            finally:
                await chan.close()
                await http.close()

        asyncio.run(main())
        worker.send_signal(signal.SIGTERM)
        report = json.loads(_wait_line(worker, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        assert worker.wait(30) == 0 and report["busy_slots"] == 0
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
