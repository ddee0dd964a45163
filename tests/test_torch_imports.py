"""The port stands alone: no module of dynamo_tpu_torch, nor chip_smoke.py,
imports jax or anything of the dynamo_tpu package (not even its modules
that are free of JAX). Checked twice: statically over every import
statement, and by importing every module in a fresh interpreter and looking
at sys.modules. serve_compare.py and stream_compare.py (GPU scripts that
run on import), latent_probe.py, spec_tie_probe.py and tp_probe.py (GPU
scripts) are checked statically."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dynamo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _static_sources():
    return sorted(_sources() + [os.path.join(REPO, f)
                                for f in ("serve_compare.py", "latent_probe.py",
                                          "spec_tie_probe.py", "stream_compare.py",
                                          "tp_probe.py")])


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _modules():
    mods = []
    for path in _sources():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel == "chip_smoke":
            mods.append(rel)
            continue
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _static_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_the_walk_covers_every_module_of_the_port():
    """Both checks above walk the package; the modules of each slice must be
    in that walk (slice 2: int8 KV, block copy, KVBM; slice 3: the gemma
    family and the model registry; then the gpt-oss family; then the
    Qwen3-MoE and MLA families and the latent attention wrapper; then the
    vision tower and the encoder cache; then the G4 remote tier, its
    service, the sharded fleet and the global KV directory)."""
    mods = set(_modules())
    assert {
        "dynamo_tpu_torch.ops.quant", "dynamo_tpu_torch.ops.block_copy",
        "dynamo_tpu_torch.kvbm", "dynamo_tpu_torch.kvbm.layout",
        "dynamo_tpu_torch.kvbm.pool", "dynamo_tpu_torch.engine.engine",
        "dynamo_tpu_torch.engine.sampling", "dynamo_tpu_torch.run", "chip_smoke",
        "dynamo_tpu_torch.models.gemma", "dynamo_tpu_torch.models.registry",
        "dynamo_tpu_torch.models.gptoss", "dynamo_tpu_torch.models.moe",
        "dynamo_tpu_torch.models.mla", "dynamo_tpu_torch.models.experts",
        "dynamo_tpu_torch.ops.cuda_mla", "dynamo_tpu_torch.models.vision",
        "dynamo_tpu_torch.llm.encoder_cache",
        "dynamo_tpu_torch.kvbm.remote", "dynamo_tpu_torch.kvbm.__main__",
        "dynamo_tpu_torch.kvbm.distributed", "dynamo_tpu_torch.kvbm.directory",
    } <= mods


# the HF-checkpoint slice reads safetensors with its own reader, and the HF
# tokenizer imports transformers only when one is built
NEVER = ("safetensors", "ml_dtypes")
DEFERRED = ("transformers", "huggingface_hub", "tokenizers")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_checkpoint_library_import_and_no_module_level_transformers(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    module_level = set(map(id, tree.body))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in NEVER or (top in DEFERRED and id(node) in module_level):
                bad.append(name)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_checkpoint_library():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {NEVER + DEFERRED!r})\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_the_walk_covers_the_feature_modules():
    """The per-request features: logits processors, guided decoding (the
    grammar compiler, numpy only) and multi-LoRA (adapter tables and the
    adapter cache)."""
    assert {
        "dynamo_tpu_torch.logits_processing", "dynamo_tpu_torch.guided",
        "dynamo_tpu_torch.guided.regex", "dynamo_tpu_torch.guided.schema",
        "dynamo_tpu_torch.guided.tokens", "dynamo_tpu_torch.lora",
        "dynamo_tpu_torch.lora.adapters", "dynamo_tpu_torch.lora.cache",
    } <= set(_modules())


def test_the_walk_covers_the_checkpoint_modules():
    assert {
        "dynamo_tpu_torch.engine.safetensors_io", "dynamo_tpu_torch.engine.weights",
        "dynamo_tpu_torch.engine.warm", "dynamo_tpu_torch.llm.hub",
        "dynamo_tpu_torch.llm.tokenizer",
    } <= set(_modules())


# the reference's serving planes import these; the machine the port serves
# on has none of them, so the port's planes (and chip_smoke.py) carry their
# own codec, HTTP server and client, validators, metrics registry, image
# decoders, protobuf codec and HTTP/2
SERVING_NEVER = ("msgpack", "aiohttp", "zmq", "pydantic", "prometheus_client", "PIL",
                 "grpc", "google", "h2", "hpack")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_serving_library_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] in SERVING_NEVER]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] in SERVING_NEVER:
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_serving_library():
    # torch itself loads modules of the ``google`` namespace package on some
    # machines (google.cloud); those, and only those, are exempt:
    # google.protobuf and every other name are never loaded
    code = (
        "import importlib, sys, torch\n"
        "torch_google = {m for m in sys.modules if m.split('.')[0] == 'google'\n"
        "                and not m.startswith('google.protobuf')}\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {SERVING_NEVER!r}\n"
        "             and m not in torch_google)\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_the_walk_covers_the_serving_plane():
    assert {
        "dynamo_tpu_torch.runtime.codec", "dynamo_tpu_torch.runtime.metrics",
        "dynamo_tpu_torch.runtime.discovery.store",
        "dynamo_tpu_torch.runtime.discovery.netstore",
        "dynamo_tpu_torch.runtime.request_plane.tcp", "dynamo_tpu_torch.runtime.component",
        "dynamo_tpu_torch.runtime.distributed", "dynamo_tpu_torch.llm.protocols.openai",
        "dynamo_tpu_torch.llm.http.service", "dynamo_tpu_torch.llm.http.server",
        "dynamo_tpu_torch.llm.discovery", "dynamo_tpu_torch.engine.__main__",
        "dynamo_tpu_torch.frontend.__main__",
    } <= set(_modules())


def test_the_walk_covers_the_kv_router_and_the_event_plane():
    assert {
        "dynamo_tpu_torch.kv_router", "dynamo_tpu_torch.kv_router.protocols",
        "dynamo_tpu_torch.kv_router.postings", "dynamo_tpu_torch.kv_router.radix_tree",
        "dynamo_tpu_torch.kv_router.indexer", "dynamo_tpu_torch.kv_router.scheduler",
        "dynamo_tpu_torch.kv_router.publisher", "dynamo_tpu_torch.kv_router.router",
        "dynamo_tpu_torch.runtime.event_plane.tcp_plane", "dynamo_tpu_torch.runtime.clock",
        "dynamo_tpu_torch.lora.routing",
    } <= set(_modules())


def test_the_walk_covers_the_router_service_and_the_parsers():
    assert {
        "dynamo_tpu_torch.router", "dynamo_tpu_torch.router.service",
        "dynamo_tpu_torch.router.__main__", "dynamo_tpu_torch.runtime.recorder",
        "dynamo_tpu_torch.parsers", "dynamo_tpu_torch.parsers.jail",
        "dynamo_tpu_torch.parsers.reasoning", "dynamo_tpu_torch.parsers.tool_calls",
    } <= set(_modules())


def test_the_walk_covers_health_status_and_observability():
    assert {
        "dynamo_tpu_torch.runtime.tracing", "dynamo_tpu_torch.runtime.flight_recorder",
        "dynamo_tpu_torch.runtime.slo", "dynamo_tpu_torch.runtime.attribution",
        "dynamo_tpu_torch.runtime.health", "dynamo_tpu_torch.ops.costs",
        "dynamo_tpu_torch.engine.telemetry", "dynamo_tpu_torch.engine.prep",
        "dynamo_tpu_torch.engine.monitor", "dynamo_tpu_torch.llm.audit",
        "dynamo_tpu_torch.llm.fleet", "dynamo_tpu_torch.llm.perf",
    } <= set(_modules())


def test_the_walk_covers_faults_breakers_and_the_request_template():
    """The fault-injection plane, the resilience policy, the task tracker and
    the request template are in both walks (no jax, no reference, no
    serving library)."""
    assert {
        "dynamo_tpu_torch.runtime.faults", "dynamo_tpu_torch.runtime.resilience",
        "dynamo_tpu_torch.runtime.tasks", "dynamo_tpu_torch.llm.request_template",
    } <= set(_modules())


def test_the_walk_covers_the_frontend_planes():
    """Image input, KServe gRPC on the port's HTTP/2, the etcd store, the
    HTTP request plane and the HTTP client under them."""
    assert {
        "dynamo_tpu_torch.llm.media", "dynamo_tpu_torch.llm.image_codecs",
        "dynamo_tpu_torch.llm.protocols.tensor", "dynamo_tpu_torch.llm.grpc",
        "dynamo_tpu_torch.llm.grpc.kserve", "dynamo_tpu_torch.llm.grpc.service",
        "dynamo_tpu_torch.runtime.hpack", "dynamo_tpu_torch.runtime.http2",
        "dynamo_tpu_torch.runtime.http_client", "dynamo_tpu_torch.runtime.discovery.etcd",
        "dynamo_tpu_torch.runtime.request_plane.http",
    } <= set(_modules())


def test_the_walk_covers_the_planned_reclaim_modules():
    """The native agent's binding, checkpoint and restore, the drain and the
    weight owner are in both walks."""
    assert {
        "dynamo_tpu_torch.transfer", "dynamo_tpu_torch.transfer.native",
        "dynamo_tpu_torch.engine.checkpoint", "dynamo_tpu_torch.engine.drain",
        "dynamo_tpu_torch.engine.weight_service",
    } <= set(_modules())


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_the_port_builds_its_own_agent(path):
    """The native agent builds from the port's csrc/transfer_agent.cpp: no
    module names the reference's library or its Makefile."""
    with open(path) as f:
        src = f.read()
    assert "libdtpu_transfer" not in src and "native/build" not in src, path
    assert '"make"' not in src and "'make'" not in src, path
