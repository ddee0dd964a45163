"""Planned reclaims in the port (dynamo_tpu_torch/engine/drain.py, the
draining steer of llm/discovery.py, the worker's ``POST /drain``), against
the reference's tests/test_drain.py cases on the CPU.

- Steering, in both packages on the same stub fleet: a draining worker is
  never a migration destination, new work steers around it, and a pool
  that is all draining still serves; the calls each package's pipeline
  makes are the same.
- The drain lease (one at a time), the coordinator flipping the discovery
  record and reporting, and ``POST /drain`` on the port's status server
  (409 with no handler, 400 on a bad deadline, 200 and the summary).
- A worker process end to end: ``POST /drain`` flips its discovery record
  to draining, checkpoints its sealed pages, and the worker exits 0; a new
  worker on the same checkpoint directory restores them warm and serves
  the prompt with them cached and the same tokens.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from types import SimpleNamespace

import aiohttp
import pytest

from dynamo_tpu.llm import discovery as jdiscovery
from dynamo_tpu.llm import model_card as jcard
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.runtime import engine as jengine
from dynamo_tpu_torch.engine.drain import DrainCoordinator, DrainLedger
from dynamo_tpu_torch.llm import discovery as tdiscovery
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.runtime.health import HealthState, StatusServer
from dynamo_tpu_torch.runtime import engine as tengine
from dynamo_tpu_torch.runtime.discovery.store import make_store
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "port": (tdiscovery, tcard, tcommon, tengine),
    "reference": (jdiscovery, jcard, jcommon, jengine),
}


class _Stream:
    def __init__(self, wid, outs):
        self.instance_id = wid
        self._iter = iter(outs)

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return next(self._iter)
        except StopIteration:
            raise StopAsyncIteration


class _StubClient:
    """Discovery and transport: ``metadata`` says which worker drains,
    ``outs_for`` what each worker's stream yields."""

    def __init__(self, workers):
        self.instances = {wid: SimpleNamespace(metadata=dict(meta))
                          for wid, meta in workers.items()}
        self.outs_for = {}
        self.calls = []
        self.sent_prior = None

    def instance_ids(self):
        return sorted(self.instances)

    async def generate(self, obj, context, instance_id):
        wid = instance_id if instance_id is not None else self.instance_ids()[0]
        self.calls.append(wid)
        self.sent_prior = list(obj.get("prior_token_ids", []))
        return _Stream(wid, self.outs_for.get(wid, []))


def _pipeline(pkg, client, migration_limit=2):
    discovery, card, _, _ = PACKAGES[pkg]
    p = discovery.ModelPipeline(None, card.ModelDeploymentCard(
        name="m", migration_limit=migration_limit))
    p.client = client
    return p


async def _run(pkg, p, rid, token_ids):
    _, _, common, engine = PACKAGES[pkg]
    req = common.PreprocessedRequest(request_id=rid, model="m", token_ids=token_ids)
    got, finishes = [], []
    async for out in p.migration.generate(req, engine.Context(rid)):
        got.extend(out.token_ids)
        finishes.append(out.finish_reason)
    return got, finishes


def _outputs(pkg, *frames):
    common = PACKAGES[pkg][2]
    return [common.BackendOutput(**f) for f in frames]


async def _never_a_migration_destination(pkg):
    # A dies mid-stream (an error finish), B drains, C is healthy: the
    # retry goes to C though B looks alive in discovery
    a, b, c = 10, 11, 12
    client = _StubClient({a: {}, b: {"state": "draining"}, c: {}})
    client.outs_for[a] = _outputs(pkg, dict(token_ids=[1]), dict(finish_reason="error"))
    client.outs_for[c] = _outputs(pkg, dict(token_ids=[2, 3], finish_reason="stop"))
    got, _ = await _run(pkg, _pipeline(pkg, client), "r1", [5, 6, 7])
    return {"calls": client.calls, "tokens": got, "prior": client.sent_prior}


async def _new_work_steers_around(pkg):
    a, b = 20, 21
    client = _StubClient({a: {"state": "draining"}, b: {}})
    client.outs_for[b] = _outputs(pkg, dict(token_ids=[9], finish_reason="stop"))
    p = _pipeline(pkg, client)
    for i in range(4):
        await _run(pkg, p, f"n{i}", [1])
    return {"calls": client.calls}


async def _whole_pool_draining_serves(pkg):
    # avoiding every draining worker would leave none: a draining worker
    # (it serves until its deadline) beats NoResponders
    a, b = 30, 31
    client = _StubClient({a: {"state": "draining"}, b: {"state": "draining"}})
    for wid in (a, b):
        client.outs_for[wid] = _outputs(pkg, dict(token_ids=[1], finish_reason="stop"))
    _, finishes = await _run(pkg, _pipeline(pkg, client), "f1", [1])
    return {"calls": client.calls, "finishes": finishes}


STEERING = {
    "never_a_migration_destination": (_never_a_migration_destination,
                                      {"calls": [10, 12], "tokens": [1, 2, 3], "prior": [1]}),
    "new_work_steers_around_draining": (_new_work_steers_around, {"calls": [21] * 4}),
    "a_fully_draining_pool_still_serves": (_whole_pool_draining_serves,
                                           {"calls": [30], "finishes": ["stop"]}),
}


@pytest.mark.parametrize("case", sorted(STEERING))
def test_draining_steers_as_the_reference(case):
    scenario, want = STEERING[case]
    port = asyncio.run(scenario("port"))
    ref = asyncio.run(scenario("reference"))
    assert port == ref == want


def test_drain_ledger_single_lease():
    led = DrainLedger()
    tok = led.acquire_drain(30.0)
    assert tok is not None and led.draining
    assert led.acquire_drain(30.0) is None   # one drain a process
    led.release_drain(tok)
    assert not led.draining
    assert led.acquire_drain(5.0) is not None


class _IdleEngine:
    def snapshot(self):
        return {"running": 0, "waiting": 0}


class _Served:
    def __init__(self):
        self.meta = {}

    async def update_metadata(self, m):
        self.meta.update(m)


async def test_drain_coordinator_flips_discovery_and_reports():
    served, fired = _Served(), []
    coord = DrainCoordinator(_IdleEngine(), served, ckpt_dir=None,
                             on_drained=lambda: fired.append(1))
    summary = await coord.begin(deadline_s=5.0)
    assert served.meta["state"] == "draining"
    assert summary["state"] == "draining" and summary["quiesced"] is True
    assert summary["deadline_margin_s"] > 0 and summary["checkpoint_blocks"] == 0
    assert fired == [1]
    assert not coord.ledger.draining   # the lease released on the way out
    # a notice while a drain runs changes nothing
    coord.ledger.acquire_drain(5.0)
    assert await coord.begin(deadline_s=5.0) == {"state": "draining", "already": True}


async def test_drain_endpoint():
    served = _Served()
    coord = DrainCoordinator(_IdleEngine(), served, ckpt_dir=None)
    server = StatusServer(HealthState(), host="127.0.0.1", drain_fn=coord.begin)
    bare = StatusServer(HealthState(), host="127.0.0.1")
    await server.start()
    await bare.start()
    try:
        async with aiohttp.ClientSession() as s:
            r = await s.post(f"http://127.0.0.1:{bare.port}/drain", json={"deadline_s": 1})
            assert r.status == 409
            r = await s.post(f"http://127.0.0.1:{server.port}/drain",
                             json={"deadline_s": "not-a-number"})
            assert r.status == 400
            r = await s.post(f"http://127.0.0.1:{server.port}/drain",
                             json={"deadline_s": 1.0})
            assert r.status == 200
            assert (await r.json())["state"] == "draining"
            assert served.meta["state"] == "draining"
    finally:
        await server.stop()
        await bare.stop()


# ------------------------------------------------------- a worker, end to end
def _wait_line(proc, prefix, timeout=90.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")


async def _drain_watched(addr, status_port):
    """POST /drain to the worker while watching its discovery record:
    (the drain's summary, every ``state`` the record was published with)."""
    from dynamo_tpu_torch.runtime import codec

    store = make_store("tcp", addr)
    watcher = await store.watch("v1/instances/")
    states = []

    async def collect():
        async for ev in watcher:
            if ev.value is not None:
                states.append(codec.unpackb(ev.value).get("metadata", {}).get("state"))

    task = asyncio.ensure_future(collect())
    try:
        async with aiohttp.ClientSession() as s:
            r = await s.post(f"http://127.0.0.1:{status_port}/drain", json={"deadline_s": 5.0})
            assert r.status == 200
            summary = await r.json()
        await asyncio.sleep(0.5)
    finally:
        watcher.cancel()
        await task
        await store.close()
    return summary, states


def test_a_worker_drains_into_a_checkpoint_its_successor_restores(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "DTPU_CKPT_DIR": str(tmp_path / "ckpt"), "DTPU_DRAIN_MARGIN_S": "0.5"}
    procs = []

    def start(*args):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig

    prompt = list(range(3, 3 + 70))   # 17 full blocks of 4

    async def generate(addr):
        rt = await DistributedRuntime(RuntimeConfig(store="tcp", store_path=addr,
                                                    event_plane="inproc")).start()
        try:
            client = await rt.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            await client.wait_for_instances(1)
            req = PreprocessedRequest(request_id="d", model="m", token_ids=prompt,
                                      stop=StopConditions(max_tokens=6, ignore_eos=True))
            toks, cached = [], None
            async for it in await client.generate(req.to_obj()):
                toks += it.get("token_ids", [])
                cached = (it.get("ann") or {}).get("cached_tokens", cached)
            return toks, cached
        finally:
            await rt.shutdown()

    worker = ("dynamo_tpu_torch.engine", "--preset", "tiny", "--model", "m", "--device",
              "cpu", "--max-context", "128", "--num-blocks", "64", "--block-size", "4",
              "--decode-steps", "1", "--decode-pipeline", "1", "--system-port", "0")
    try:
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        first = start(*worker, *common)
        status = int(_wait_line(first, "TORCH_STATUS_ADDRESS").rsplit(":", 1)[1])
        _wait_line(first, "TORCH_ENGINE_READY")
        toks, _ = asyncio.run(generate(addr))
        worker_doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{status}/debug/worker", timeout=30).read())
        sealed = worker_doc["engine"]["cached_blocks"]
        assert sealed >= 17 and worker_doc["drain"] == {"draining": False, "last": None}
        summary, states = asyncio.run(_drain_watched(addr, status))
        assert "draining" in states
        assert summary["quiesced"] is True and summary["checkpoint_blocks"] == sealed
        report = json.loads(_wait_line(first, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        assert first.wait(30) == 0
        assert report["drain"]["checkpoint_blocks"] == sealed
        assert len(os.listdir(tmp_path / "ckpt" / "blocks")) == sealed
        second = start(*worker, *common)
        line = _wait_line(second, "CHECKPOINT_RESTORE")
        assert line.split()[1:4] == ["mode=warm", f"blocks={sealed}", "windows=1"]
        _wait_line(second, "TORCH_ENGINE_READY")
        again, cached = asyncio.run(generate(addr))
        assert again == toks and cached == (len(prompt) - 1) // 4 * 4
        second.send_signal(signal.SIGTERM)
        report = json.loads(_wait_line(second, "TORCH_ENGINE_EXIT").split(" ", 1)[1])
        assert second.wait(30) == 0 and report["restore"]["mode"] == "warm"
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
