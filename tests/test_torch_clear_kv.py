"""``clear_kv_blocks`` on the port, held to the reference.

- The engine: a tiny TorchEngine and the reference's TpuEngine on the same
  float32 weights serve the same requests, then clear their caches with
  the same sequence of ``levels``: the same results (blocks dropped per
  level, the snapshot's block counts) and the same refusals. The port's
  engine with a KVBM host tier drops and reports its g2 blocks.
- The router: the CLEARED event a g1 clear publishes empties a KV
  indexer's view of the worker.
- The frontend: ``POST /clear_kv_blocks`` on the port's HttpService and on
  the reference's gives the same 400s and 404; on the port it fans out to a
  TorchEngine worker's ``clear_kv_blocks`` endpoint (llm/serve.py) and
  reports the worker's result.
"""

import asyncio
import json

import pytest

from dynamo_tpu import kv_router as J
from dynamo_tpu_torch import kv_router as T
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kv_router import KvIndexer, WorkerWithDpRank
from dynamo_tpu_torch.kvbm.layout import block_shape_for
from dynamo_tpu_torch.kvbm.pool import KvbmTiers
from dynamo_tpu_torch.runtime.http_client import HttpClient
from test_torch_kv_events import BS, ENGINE, MODEL, RecordingPlane, decoded, wait_idle
from torch_feature_engines import Weights, collect, request, tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

LEVELS = [[], ["g2", "g3"], ["G1"], ["g1"], None, "g1", [1], ("g1",)]
SNAP_KEYS = ("running", "waiting", "active_blocks", "cached_blocks", "free_blocks")


def _requests():
    a, b = tokens(11, 30, 256), tokens(12, 22, 256)
    return [("a", a, 4), ("b", b, 3), ("a2", a + tokens(13, 9, 256), 4)]


@pytest.fixture(scope="module")
def cleared():
    weights = Weights(MODEL)

    def run(jax_side):
        plane = RecordingPlane()
        if jax_side:
            engine = weights.jax_engine(ENGINE)
            engine.kv_publisher = J.KvEventPublisher(plane, "ns", "be", worker_id=3,
                                                     block_size=BS)
        else:
            engine = weights.torch_engine(ENGINE)
            engine.kv_publisher = T.KvEventPublisher(plane, "ns", "be", worker_id=3,
                                                     block_size=BS)

        async def main():
            try:
                for rid, toks, n in _requests():
                    await collect(engine, request(jax_side, rid, toks, n, ignore_eos=True))
                await wait_idle(engine)
                before = len(plane.sent)
                results = []
                for levels in LEVELS:
                    try:
                        r = await engine.clear_kv_blocks(levels)
                        snap = r.pop("snapshot")
                        results.append(("ok", r, {k: snap[k] for k in SNAP_KEYS}))
                    except ValueError as e:
                        results.append(("error", str(e)))
                return results, before
            finally:
                engine.stop()

        results, before = asyncio.run(main())
        return results, decoded(plane.sent), before

    return run(True), run(False)


def test_clear_kv_blocks_results_and_refusals_equal_the_reference(cleared):
    (ref, _, _), (port, _, _) = cleared
    assert port == ref
    g1 = [r[1].get("g1") for r in port if r[0] == "ok" and "g1" in r[1]]
    assert g1[0] > 0 and g1[1:] == [0, 0, 0]   # the first g1 clear emptied the cache
    assert [r[0] for r in port].count("error") == 2


def test_the_cleared_event_empties_the_routers_view(cleared):
    (_, ref_events, ref_before), (_, events, before) = cleared
    kinds = [ev.event.kind.value for ev in events[before:]]
    assert kinds == [ev.event.kind.value for ev in ref_events[ref_before:]]
    assert kinds.count("cleared") == 4          # ["G1"], ["g1"], None, ("g1",)
    idx = KvIndexer(block_size=BS)
    for ev in events[:before]:
        idx.apply(ev)
    assert idx.tree.worker_hashes(WorkerWithDpRank(3))
    for ev in events[before:]:
        idx.apply(ev)
    assert not idx.tree.worker_hashes(WorkerWithDpRank(3))


def test_a_kvbm_engine_drops_and_reports_its_host_tier():
    weights = Weights(MODEL)
    nbytes = block_shape_for(weights.tcfg, BS).nbytes
    kvbm = KvbmTiers(nbytes, host_capacity_bytes=64 * nbytes)
    engine = TorchEngine(TorchEngineConfig(model=weights.tcfg, device="cpu",
                                           **dict(ENGINE, num_blocks=14)),
                         params=params_from_numpy(weights.tree, weights.tcfg, device="cpu"),
                         kvbm=kvbm)
    plane = RecordingPlane()
    engine.kv_publisher = T.KvEventPublisher(plane, "ns", "be", worker_id=3, block_size=BS)

    async def main():
        try:
            for k in range(6):
                await collect(engine, request(False, f"r{k}", tokens(40 + k, 24, 256), 2,
                                              ignore_eos=True))
            await wait_idle(engine)
            await engine.flush_offload()
            held = len(kvbm.host)
            result = await engine.clear_kv_blocks(["g2"])
            return held, result, len(kvbm.host)
        finally:
            engine.stop()

    held, result, after = asyncio.run(main())
    assert held > 0 and result["g2"] == held and after == 0
    assert "g1" not in result and result["snapshot"]["kvbm"]["host_blocks"] == 0


BAD_BODIES = [b'{"levels": "g1"}', b'{"levels": [1]}', b"{not json",
              b'{"model": "nope"}', b'{"model": "nope", "levels": ["g1"]}']


async def _post_all(port, bodies):
    http = HttpClient()
    out = []
    try:
        for body in bodies:
            r = await http.request("POST", f"http://127.0.0.1:{port}/clear_kv_blocks", body,
                                   {"Content-Type": "application/json"})
            out.append((r.status, json.loads(await r.read())))
    finally:
        await http.close()
    return out


async def test_the_frontends_refusals_equal_the_reference():
    from dynamo_tpu.llm.discovery import ModelManager as JManager
    from dynamo_tpu.llm.http.service import HttpService as JService
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http.service import HttpService

    got = {}
    for name, svc in (("port", HttpService(ModelManager(), host="127.0.0.1", port=0)),
                      ("reference", JService(JManager(), host="127.0.0.1", port=0))):
        await svc.start()
        try:
            got[name] = await _post_all(svc.port, BAD_BODIES + [b"", b"{}"])
        finally:
            await svc.stop()
    assert got["port"] == got["reference"]
    assert [s for s, _ in got["port"]] == [400, 400, 400, 404, 404, 200, 200]


async def test_the_frontend_fans_out_to_the_workers_endpoint():
    from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.serve import register_llm, serve_clear_endpoint
    from dynamo_tpu_torch.runtime import DistributedRuntime, MemKVStore, RuntimeConfig

    engine = Weights(MODEL).torch_engine(ENGINE)
    store = MemKVStore()
    cfg = RuntimeConfig(store="mem", event_plane="inproc", lease_ttl_s=2.0)
    rts = [await DistributedRuntime(cfg, store=store).start() for _ in range(2)]
    card = ModelDeploymentCard(name="m", tokenizer="byte", context_length=128,
                               kv_block_size=BS)
    served = await register_llm(rts[0], engine, card)
    clear = await serve_clear_endpoint(rts[0], card.namespace, card.component, [engine],
                                       served.instance_id)
    manager = ModelManager()
    watcher = await ModelWatcher(rts[1], manager).start()
    svc = HttpService(manager, host="127.0.0.1", port=0)
    await svc.start()
    try:
        for _ in range(200):
            if manager.get("m") and manager.get("m").client.instances:
                break
            await asyncio.sleep(0.02)
        await collect(engine, request(False, "warm", tokens(7, 30, 256), 3, ignore_eos=True))
        await wait_idle(engine)
        cached = engine.allocator.cached_blocks
        (status, body), (status2, body2) = await _post_all(
            svc.port, [b'{"levels": ["g1"]}', b'{"model": "m"}'])
        worker = f"{served.instance_id:016x}"
        assert status == 200 and cached > 0
        assert body["cleared"]["m"][worker]["g1"] == cached
        assert body["cleared"]["m"][worker]["snapshot"]["cached_blocks"] == 0
        assert status2 == 200 and body2["cleared"]["m"][worker]["g1"] == 0
        assert engine.allocator.cached_blocks == 0
    finally:
        await svc.stop()
        await watcher.stop()
        await clear.stop()
        await served.stop()
        engine.stop()
        for rt in rts:
            await rt.shutdown()
