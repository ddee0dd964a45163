"""The port's standalone KV-router service (dynamo_tpu_torch/router) and its
event recorder (runtime/recorder.py) against the reference package's, on
the CPU.

- Recorder: a port recording and a reference recording of the same events
  are equal line for line apart from the timestamps, and each package's
  ``load()`` reads the other's file; rotation (``max_lines_per_file``),
  ``max_count`` and ``replay()`` behave as the reference's.
- ``KvRouter(recorder=)``: both packages' routers, fed the same KV events
  over their event planes, record equal streams.
- ``RouterService``: the port's and the reference's, each on its own
  in-process runtime (MemKVStore, InProcEventPlane) over three registered
  worker instances of two dp ranks each, are fed the same seeded KV-event
  stream and load reports, and are asked the same ``route`` / ``free`` /
  ``state`` requests over the request plane: the answers are equal
  (router ids aside), with and without replica sync (two services per
  package, asked in turn). A worker that leaves is pruned from both.
- ``python -m dynamo_tpu_torch.router --record-events`` beside a tiny CPU
  worker over a tcp store and the port's event broker: the route op before
  and after the worker served a prompt, the worker's card naming its
  parsers, the service's exit view equal to the worker's prefix cache,
  and the recording replayed into a fresh KvRouter to the same view; a
  worker with an unknown parser name fails at start.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from dynamo_tpu import kv_router as J
from dynamo_tpu import runtime as jrt
from dynamo_tpu.router import RouterService as JRouterService
from dynamo_tpu.runtime.recorder import Recorder as JRecorder
from dynamo_tpu_torch import kv_router as T
from dynamo_tpu_torch.router import RouterService
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RuntimeConfig,
    codec,
)
from dynamo_tpu_torch.runtime.recorder import Recorder
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4
INSTANCES = (0x11, 0x22, 0x33)
DP = 2


# ------------------------------------------------------------------ recorder
def _events(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"kind": "kv_event", "event": {
        "worker": [int(rng.integers(0, 4)), 0], "id": i,
        "event": {"kind": "stored", "hashes": rng.integers(0, 2**63, size=3).tolist(),
                  "parent": None, "block_size": BS}}} for i in range(n)]


async def _record(cls, path, events, **kw):
    rec = await cls(str(path), **kw).start()
    for e in events:
        rec.record(e)
    await rec.stop()
    return rec


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@pytest.mark.parametrize("kw", [{}, {"max_lines_per_file": 7}, {"max_count": 11},
                                 {"max_lines_per_file": 5, "max_count": 12}],
                         ids=["plain", "rotation", "max_count", "both"])
async def test_recordings_equal_the_references(tmp_path, kw):
    events = _events(25)
    port = await _record(Recorder, tmp_path / "port.jsonl", events, **kw)
    ref = await _record(JRecorder, tmp_path / "ref.jsonl", events, **kw)
    assert port.event_count == ref.event_count == min(25, kw.get("max_count", 25))
    port_files = sorted(p for p in os.listdir(tmp_path) if p.startswith("port"))
    ref_files = sorted(p for p in os.listdir(tmp_path) if p.startswith("ref"))
    assert [p.replace("port", "") for p in port_files] == \
        [p.replace("ref", "") for p in ref_files]
    if "max_lines_per_file" in kw:
        assert len(port_files) > 1
    for pf, rf in zip(port_files, ref_files):
        a, b = _lines(tmp_path / pf), _lines(tmp_path / rf)
        assert [set(x) for x in a] == [{"timestamp", "event"}] * len(a)
        assert [x["event"] for x in a] == [x["event"] for x in b]
        assert all(isinstance(x["timestamp"], int) for x in a)
        # each package reads the other's file
        assert Recorder.load(str(tmp_path / rf)) and JRecorder.load(str(tmp_path / pf))
        assert [e for _, e in Recorder.load(str(tmp_path / rf))] == \
            [e for _, e in JRecorder.load(str(tmp_path / pf))]


async def test_replay_yields_the_recorded_events_in_order(tmp_path):
    events = _events(6, seed=3)
    await _record(Recorder, tmp_path / "r.jsonl", events)
    got = [e async for e in Recorder.replay(str(tmp_path / "r.jsonl"), speedup=0)]
    ref = [e async for e in JRecorder.replay(str(tmp_path / "r.jsonl"), speedup=0)]
    assert got == ref == events


async def test_max_time_stops_the_recorder(tmp_path):
    rec = await Recorder(str(tmp_path / "t.jsonl"), max_time_s=0.05).start()
    assert rec.record({"a": 1})
    await asyncio.sleep(0.5)
    assert not rec.record({"a": 2})      # past its time: the writer has stopped
    await rec.stop()
    assert [e for _, e in Recorder.load(str(tmp_path / "t.jsonl"))] == [{"a": 1}]


async def test_kv_routers_record_what_they_ingest_as_the_reference(tmp_path):
    prompts = [list(range(i, i + 4 * (3 + i))) for i in range(4)]

    async def run(pkg, plane, rec_cls, path):
        rec = await rec_cls(str(path)).start()
        router = await pkg.KvRouter(plane, "ns", "be", block_size=BS, recorder=rec).start()
        pubs = [pkg.KvEventPublisher(plane, "ns", "be", worker_id=w, block_size=BS)
                for w in (3, 4)]
        for i, p in enumerate(prompts):
            await pubs[i % 2].stored(compute_sequence_hashes(p, BS))
        await pubs[0].removed(compute_sequence_hashes(prompts[0], BS)[2:])
        await pubs[1].cleared()
        for _ in range(20):
            await asyncio.sleep(0.01)
        await router.stop()
        await rec.stop()
        await plane.close()
        return [e for _, e in rec_cls.load(str(path))]

    port = await run(T, InProcEventPlane(), Recorder, tmp_path / "p.jsonl")
    ref = await run(J, jrt.InProcEventPlane(), JRecorder, tmp_path / "r.jsonl")
    assert port == ref and len(port) == 6
    assert {e["kind"] for e in port} == {"kv_event"}


# ------------------------------------------------------------ router service
def _stream(seed):
    """Seeded prompts and a KV-event stream over them: (prompts, events),
    an event (instance, dp rank, kind, prompt index, first block, last)."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 500, size=4 * int(rng.integers(3, 9))).tolist()
            for _ in range(8)]
    prompts = base + [b[:4 * int(rng.integers(1, len(b) // 4))] +
                      rng.integers(0, 500, size=8).tolist() for b in base[:4]]
    events = []
    for _ in range(60):
        iid, r = INSTANCES[int(rng.integers(3))], int(rng.integers(DP))
        p = int(rng.integers(len(prompts)))
        n = len(prompts[p]) // BS
        kind = "stored" if rng.random() < 0.75 else ("removed" if rng.random() < 0.9
                                                       else "cleared")
        events.append((iid, r, kind, p, int(rng.integers(0, n)), n))
    return prompts, events


async def _feed(pkg, plane, prompts, events, seed):
    pubs = {(i, r): pkg.KvEventPublisher(plane, "dynamo", "backend", worker_id=i,
                                         dp_rank=r, block_size=BS)
            for i in INSTANCES for r in range(DP)}
    for iid, r, kind, p, lo, hi in events:
        hs = compute_sequence_hashes(prompts[p], BS)
        pub = pubs[(iid, r)]
        if kind == "stored":
            await pub.stored(hs[:hi])
        elif kind == "removed":
            await pub.removed(hs[lo:hi])
        else:
            await pub.cleared()
    rng = np.random.default_rng(seed + 7)
    for i in INSTANCES:
        for r in range(DP):
            await pkg.WorkerMetricsPublisher(plane, "dynamo", "backend", worker_id=i,
                                             dp_rank=r).publish(
                active_decode_blocks=int(rng.integers(0, 6)))


def _queries(prompts, seed, n=24):
    rng = np.random.default_rng(seed + 99)
    out = []
    for k in range(n):
        p = prompts[int(rng.integers(len(prompts)))]
        cut = 4 * int(rng.integers(1, len(p) // 4 + 1))
        out.append((f"q{k}", p[:cut] + rng.integers(0, 500, size=6).tolist(),
                    rng.random() < 0.5))
    return out


async def _serve_package(port: bool, prompts, events, seed, replicas, drop=None):
    """One package's runtime family: worker instances, ``replicas``
    services, a caller; the answers to every query, in order."""
    if port:
        store, plane = MemKVStore(), InProcEventPlane()
        cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
        make = lambda: DistributedRuntime(cfg, store=store, event_plane=plane)  # noqa: E731
        pkg, svc_cls, kvcfg = T, RouterService, T.KvRouterConfig
    else:
        store, plane = jrt.MemKVStore(), jrt.InProcEventPlane()
        cfg = jrt.RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
        make = lambda: jrt.DistributedRuntime(cfg, store=store, event_plane=plane)  # noqa: E731
        pkg, svc_cls, kvcfg = J, JRouterService, J.KvRouterConfig
    worker_rt, caller_rt = await make().start(), await make().start()

    async def nothing(request, context):
        yield {}

    ep = worker_rt.namespace("dynamo").component("backend").endpoint("generate")
    workers = {iid: await ep.serve(nothing, instance_id=iid,
                                   metadata={"data_parallel_size": DP})
               for iid in INSTANCES}
    svc_rts = [await make().start() for _ in range(replicas)]
    services = []
    for rt in svc_rts:
        services.append(await svc_cls(rt, block_size=BS, config=kvcfg(
            replica_sync=replicas > 1)).start())
        await asyncio.sleep(0.3)     # a late joiner's snapshot request goes unanswered
    out = []
    try:
        for s in services:
            await s.client.wait_for_instances(len(INSTANCES), timeout=10)
        client = await caller_rt.namespace("dynamo").component("backend-router") \
            .endpoint("route").client()
        await client.wait_for_instances(replicas, timeout=10)
        await _feed(pkg, plane, prompts, events, seed)
        for _ in range(50):
            await asyncio.sleep(0.01)
        iids = [s.served.instance_id for s in services]

        async def ask(k, req):
            return [x async for x in await client.generate(req, instance_id=iids[k % len(iids)])]

        for k, (rid, toks, free) in enumerate(_queries(prompts, seed)):
            if drop is not None and k == 12:
                await workers.pop(drop).stop()
                for s in services:
                    for _ in range(200):
                        if drop not in s.client.instances:
                            break
                        await asyncio.sleep(0.01)
            out.append(await ask(k, {"op": "route", "request_id": rid, "token_ids": toks}))
            if free:
                out.append(await ask(k, {"op": "free", "request_id": rid}))
            await asyncio.sleep(0.02)     # a replica's sync message lands
        for k in range(len(iids)):
            st = await ask(k, {"op": "state"})
            out.append([{**x, "router_id": None, "workers": sorted(x["workers"])}
                        for x in st])
        out.append(await ask(0, {"op": "nope"}))
        await client.stop()
    finally:
        for s in services:
            await s.stop()
        for w in workers.values():
            await w.stop()
        for rt in svc_rts + [worker_rt, caller_rt]:
            await rt.shutdown()
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("replicas", [1, 2], ids=["alone", "replica_sync"])
async def test_router_service_answers_equal_the_reference(seed, replicas):
    prompts, events = _stream(seed)
    ref = await _serve_package(False, prompts, events, seed, replicas)
    port = await _serve_package(True, prompts, events, seed, replicas)
    assert port == ref
    routes = [a[0] for a in port if a and "overlap_blocks" in a[0]]
    assert len(routes) == 24
    assert any(r["overlap_blocks"] > 0 for r in routes)
    assert len({(r["worker_id"], r["dp_rank"]) for r in routes}) > 1


async def test_a_worker_that_leaves_is_pruned_as_by_the_reference():
    prompts, events = _stream(3)
    ref = await _serve_package(False, prompts, events, 3, 1, drop=INSTANCES[0])
    port = await _serve_package(True, prompts, events, 3, 1, drop=INSTANCES[0])
    assert port == ref
    routes = [a[0] for a in port if a and "overlap_blocks" in a[0]]
    assert all(r["worker_id"] != INSTANCES[0] for r in routes[12:])
    state = port[-2][0]
    assert all(w[0] != INSTANCES[0] for w in state["workers"])


async def test_route_with_an_adapter_scores_its_salted_chain():
    """The port's own ``lora`` key of the route op: the worker that reports
    the adapter and holds its salted chain is scored on it."""
    store, plane = MemKVStore(), InProcEventPlane()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    worker_rt, svc_rt = [await DistributedRuntime(cfg, store=store, event_plane=plane).start()
                         for _ in range(2)]

    async def nothing(request, context):
        yield {}

    ep = worker_rt.namespace("dynamo").component("backend").endpoint("generate")
    served = [await ep.serve(nothing, instance_id=iid) for iid in (1, 2)]
    svc = await RouterService(svc_rt, block_size=BS).start()
    key = bytes(range(16))
    prompt = list(range(24))
    try:
        await svc.client.wait_for_instances(2)
        pub = T.KvEventPublisher(plane, "dynamo", "backend", worker_id=2, block_size=BS)
        await pub.stored(compute_sequence_hashes(prompt, BS, extra_key=key))
        await T.WorkerMetricsPublisher(plane, "dynamo", "backend", worker_id=2).publish(
            adapters={"ad": key.hex()})
        await asyncio.sleep(0.05)
        (got,) = [x async for x in svc.handle(
            {"op": "route", "request_id": "a", "token_ids": prompt, "lora": "ad"}, None)]
        (base,) = [x async for x in svc.handle(
            {"op": "route", "request_id": "b", "token_ids": prompt}, None)]
    finally:
        await svc.stop()
        for s in served:
            await s.stop()
        for rt in (worker_rt, svc_rt):
            await rt.shutdown()
    assert got == {"worker_id": 2, "dp_rank": 0, "overlap_blocks": 6, "cached_tokens": 24}
    assert base["overlap_blocks"] == 0


# ---------------------------------------------------------------- the CLI
def test_router_entry_point_beside_a_worker(tmp_path):
    """netstore, ``python -m dynamo_tpu_torch.router --record-events`` (it
    founds the event broker) and a tiny CPU worker with parser flags: the
    card names the parsers; a prompt the worker has served routes back to
    it with its blocks; at exit the service's view equals the worker's
    prefix cache, and the recording replays into a fresh KvRouter to the
    same view. A worker with an unknown parser name fails at start."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = []

    def start(*args):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    record = str(tmp_path / "events.jsonl")
    prompt = list(range(1, 42))
    try:
        bad = start("dynamo_tpu_torch.engine", "--tool-parser", "nope", "--device", "cpu")
        assert bad.wait(60) != 0
        assert "unknown tool parser 'nope'" in bad.stdout.read()
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr, "--event-plane", "zmq")
        router = start("dynamo_tpu_torch.router", *common, "--block-size", "4",
                       "--record-events", record)
        _wait_line(router, "ROUTER_READY")
        worker = start("dynamo_tpu_torch.engine", *common, "--preset", "tiny", "--model", "m",
                       "--device", "cpu", "--max-context", "256", "--num-blocks", "64",
                       "--block-size", "4", "--decode-steps", "1", "--decode-pipeline", "1",
                       "--tool-parser", "hermes", "--reasoning-parser", "qwen3")
        _wait_line(worker, "TORCH_ENGINE_READY")
        answers, card = asyncio.run(_route_serve_route(addr, prompt))
        assert (card["tool_parser"], card["reasoning_parser"]) == ("hermes", "qwen3")
        first, second = answers
        assert first["overlap_blocks"] == 0 and first["worker_id"] == second["worker_id"]
        assert second["cached_tokens"] == 4 * (len(prompt) // 4)
        router.send_signal(signal.SIGTERM)
        view = json.loads(_wait_line(router, "ROUTER_EXIT").split(" ", 1)[1])
        assert router.wait(30) == 0
        worker.send_signal(signal.SIGTERM)
        report = json.loads(_wait_line(worker, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        assert worker.wait(30) == 0
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
    seen = view["workers"][report["worker_id"]]
    assert seen == report["prefix_cache"] and seen["blocks"] > 0
    assert view["recorded"] == view["events_applied"] == sum(report["kv_events"].values())
    replayed = T.KvRouter(InProcEventPlane(), "dynamo", "backend", block_size=4)
    for _, ev in Recorder.load(record):
        replayed.indexer.apply(T.RouterEvent.from_obj(ev["event"]))
    assert replayed.view()["workers"] == view["workers"]


async def _route_serve_route(addr, prompt):
    """Ask the service, serve the prompt on its worker, ask again."""
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )

    rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                event_plane="inproc")).start()
    try:
        route = await rt.namespace("dynamo").component("backend-router").endpoint(
            "route").client()
        gen = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await route.wait_for_instances(1)
        await gen.wait_for_instances(1)
        cards = await rt.store.list_prefix("v1/mdc/")
        card = codec.unpackb(next(iter(cards.values())))

        async def ask(rid):
            return [x async for x in await route.generate(
                {"op": "route", "request_id": rid, "token_ids": prompt})][0]

        first = await ask("a")
        req = PreprocessedRequest(request_id="a", model="m", token_ids=prompt,
                                  stop=StopConditions(max_tokens=3, ignore_eos=True),
                                  sampling=SamplingOptions(temperature=0.0))
        async for _ in await gen.generate(req.to_obj(), instance_id=first["worker_id"]):
            pass
        await asyncio.sleep(1.0)       # the worker's events cross the broker
        second = await ask("b")
        await route.stop()
        await gen.stop()
        return (first, second), card
    finally:
        await rt.shutdown()


def _wait_line(proc, prefix, timeout=90.0):
    import time

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")
