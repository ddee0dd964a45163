"""The port's engine as a KV-event source, and KV-aware routing end to end,
on the CPU.

- Events: a tiny TorchEngine and the reference's TpuEngine on the same
  float32 weights (``params_from_numpy``) serve the same requests one at a
  time from a 24-block pool that evicts, each publishing through its own
  package's ``KvEventPublisher``. The stored events of prompt blocks must
  come in the same sequence, and the removed ones too, and once idle the
  engines' prefix caches must hold the same hashes, which equal what each
  one's events add up to. (The port commits a decode-sealed block a tick
  later than the reference, once its last row is written, so the events of
  generated blocks are not compared one by one; and within a tick it
  publishes the removals before the stores, so the two kinds are compared
  as two sequences.)
- The drain: with no publisher attached, 200 requests later the
  allocator's event lists are empty once the engine is idle.
- End to end: a ``--router-mode kv`` pipeline over two TorchEngine workers,
  three runtimes on one store and the port's cross-process event plane:
  each follow-up goes to the worker that served its document and finds
  its prefix cached, and the router's view of each worker equals that
  worker's prefix cache once idle.
- The adapter salt: the port's engine salts an adapter request's blocks
  with the adapter load's key and reports its keys with its load; the
  router hashes an adapter request with each worker's key, so its
  predicted cached tokens equal the worker's report for base, adapter and
  reloaded-adapter requests, and a worker without the adapter scores no
  overlap (ROADMAP Queue 3).
"""

import asyncio
from types import SimpleNamespace

import pytest

from dynamo_tpu import kv_router as J
from dynamo_tpu.tokens import compute_sequence_hashes as jhashes
from dynamo_tpu_torch import kv_router as T
from dynamo_tpu_torch.kv_router import KvIndexer, KvRouter, KvRouterConfig, WorkerWithDpRank
from dynamo_tpu_torch.kv_router.protocols import RouterEvent
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelPipeline, ModelWatcher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.serve import register_llm
from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    InProcEventPlane,
    MemKVStore,
    RouterMode,
    RuntimeConfig,
    codec,
)
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from test_torch_lora import ENGINE as LORA_ENGINE
from test_torch_lora import MODEL as LORA_MODEL
from test_torch_lora import TCFG as LORA_TCFG
from test_torch_lora import _adapter_weights
from torch_feature_engines import Weights, collect, request, tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)
BS = 4
ENGINE = dict(num_blocks=24, block_size=BS, max_batch_size=4, max_context=128,
              prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1)


class RecordingPlane:
    def __init__(self):
        self.sent = []

    async def publish(self, topic, payload):
        self.sent.append(payload)


async def wait_idle(engine, timeout=10.0):
    """Until no slot is busy and nothing waits, then one more beat for the
    tick that freed the last slot to publish its events."""
    for _ in range(int(timeout / 0.01)):
        if not engine._waiting and all(s is None for s in engine._slots):
            await asyncio.sleep(0.1)
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the engine never went idle")


def sequential_requests():
    """(rid, prompt, max tokens) one at a time: shared prefixes, repeats,
    and enough distinct prompts to evict from a 24-block pool."""
    a, b, c = tokens(1, 30, 256), tokens(2, 22, 256), tokens(3, 40, 256)
    return [("a", a, 4), ("a+", a + tokens(4, 13, 256), 5), ("b", b, 3), ("a-again", a, 4),
            ("c", c, 6), ("b+", b + tokens(5, 9, 256), 4), ("d", tokens(6, 50, 256), 3),
            ("a-late", a, 4), ("c+", c + tokens(7, 7, 256), 5), ("e", tokens(8, 35, 256), 4)]


def decoded(payloads):
    """RouterEvents from either package's payload bytes (one codec)."""
    return [RouterEvent.from_obj(codec.unpackb(p)) for p in payloads]


@pytest.fixture(scope="module")
def engine_events():
    weights = Weights(MODEL)
    prompt_hashes = set()
    for _, toks, _ in sequential_requests():
        prompt_hashes.update(jhashes(toks, BS))

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
            outs = []
            try:
                for rid, toks, n in sequential_requests():
                    outs.append(await collect(engine, request(jax_side, rid, toks, n,
                                                              ignore_eos=True)))
                await wait_idle(engine)
                return outs, set(engine.allocator._by_hash)
            finally:
                engine.stop()

        outs, cache = asyncio.run(main())
        return {"outs": outs, "cache": cache, "events": decoded(plane.sent)}

    return run(True), run(False), prompt_hashes


def prompt_block_events(events, prompt_hashes):
    """{kind: [prompt-block hashes of each event, in order]}."""
    out = {}
    for ev in events:
        hs = [h for h in ev.event.block_hashes if h in prompt_hashes]
        if hs:
            out.setdefault(ev.event.kind.value, []).append(hs)
    return out


def test_prompt_block_events_equal_the_reference(engine_events):
    ref, port, prompt_hashes = engine_events
    assert [o["tokens"] for o in port["outs"]] == [o["tokens"] for o in ref["outs"]]
    assert [o["cached"] for o in port["outs"]] == [o["cached"] for o in ref["outs"]]
    want = prompt_block_events(ref["events"], prompt_hashes)
    got = prompt_block_events(port["events"], prompt_hashes)
    assert got == want
    assert set(got) == {"stored", "removed"}, got   # the pool evicted


def test_idle_prefix_caches_equal_the_reference_and_the_events(engine_events):
    ref, port, _ = engine_events
    assert port["cache"] == ref["cache"]
    for side in (ref, port):
        idx = KvIndexer(block_size=BS)
        for ev in side["events"]:
            idx.apply(ev)
        assert idx.tree.worker_hashes(WorkerWithDpRank(3)) == side["cache"]


def test_allocator_events_are_drained_every_tick():
    """200 requests, no publisher attached: both event lists empty once
    the engine is idle (they grew without bound before the drain)."""
    engine = Weights(MODEL).torch_engine(ENGINE)
    assert engine.kv_publisher is None

    async def main():
        try:
            for k in range(50):
                await asyncio.gather(*(
                    collect(engine, request(False, f"r{k}-{i}", tokens(100 + 4 * k + i,
                                                                      9 + (k + i) % 20, 256),
                                            2, ignore_eos=True)) for i in range(4)))
            await wait_idle(engine)
            return engine.allocator.events_stored, engine.allocator.events_removed
        finally:
            engine.stop()

    stored, removed = asyncio.run(main())
    assert stored == [] and removed == []


# ---------------------------------------------------------------- end to end
M = "m"


def _worker_engine(weights):
    return weights.torch_engine(dict(ENGINE, num_blocks=64))


def _preq(rid, toks, n=4):
    return PreprocessedRequest(request_id=rid, model=M, token_ids=list(toks),
                               stop=StopConditions(max_tokens=n, ignore_eos=True),
                               sampling=SamplingOptions(temperature=0.0))


async def _first_and_all(pipe, req):
    first, n = None, 0
    async for out in pipe.generate_tokens(req, Context()):
        first = first or dict(out.annotations or {})
        n += len(out.token_ids)
    return first, n


@pytest.mark.parametrize("kv_events", [True, False], ids=["events", "no_kv_events"])
def test_kv_pipeline_routes_followups_to_their_documents_worker(kv_events):
    """With events (the port's cross-process plane) the router's view of
    each worker ends equal to its cache; with ``--no-kv-events`` the
    approximate indexer predicts the caches from its own decisions, and
    the follow-ups go to their documents' workers all the same."""
    weights = Weights(MODEL)

    async def main():
        store = MemKVStore()
        cfg = RuntimeConfig(store="mem", event_plane="zmq" if kv_events else "inproc")
        front = await DistributedRuntime(cfg, store=store).start()   # founds the broker
        workers = [await DistributedRuntime(cfg, store=store).start() for _ in range(2)]
        engines, served = [], []
        for i, rt in enumerate(workers):
            engine = _worker_engine(weights)
            iid = 1000 + i
            engine.kv_publisher = T.KvEventPublisher(rt.event_plane, "dynamo", "backend",
                                                     worker_id=iid, block_size=BS)
            engine.metrics_publisher = T.WorkerMetricsPublisher(rt.event_plane, "dynamo",
                                                                "backend", worker_id=iid)
            served.append(await register_llm(rt, engine, ModelDeploymentCard(
                name=M, tokenizer="byte", context_length=128, kv_block_size=BS),
                instance_id=iid))
            engines.append(engine)
        manager = ModelManager()
        watcher = await ModelWatcher(front, manager, RouterMode.KV,
                                     KvRouterConfig(use_kv_events=kv_events)).start()
        try:
            for _ in range(300):
                pipe = manager.get(M)
                if pipe and len(pipe.client.instances) == 2:
                    break
                await asyncio.sleep(0.02)
            assert pipe.kv_router is not None
            docs = [tokens(40 + i, 30 + 6 * i, 256) for i in range(4)]
            placed = []
            for i, d in enumerate(docs):
                ann, n = await _first_and_all(pipe, _preq(f"doc{i}", d))
                assert n == 4
                placed.append(ann["worker_id"])
            assert set(placed) == {1000, 1001}
            await asyncio.sleep(0.2)   # the events cross the broker
            for i in (2, 0, 3, 1):
                # a beat for the last worker's idle load report: the router's
                # cost is prefill blocks plus load, and a report still
                # carrying the previous request's blocks could rightly send
                # a follow-up to the idle worker
                await asyncio.sleep(0.2)
                ann, _ = await _first_and_all(
                    pipe, _preq(f"fu{i}", docs[i] + tokens(60 + i, 10, 256)))
                assert ann["worker_id"] == placed[i], (i, ann)
                assert ann["cached_tokens"] >= (len(docs[i]) // BS - 1) * BS, (i, ann)
            await asyncio.sleep(0.2)
            for e in engines:
                await wait_idle(e)
            tree = pipe.kv_router.indexer.tree
            for iid, e in zip((1000, 1001), engines):
                view = tree.worker_hashes(WorkerWithDpRank(iid))
                if kv_events:
                    assert view == set(e.allocator._by_hash)
                else:   # the routed prompts' blocks, full ones only
                    assert view and view <= set(e.allocator._by_hash)
        finally:
            await watcher.stop()
            for s in served:
                await s.stop()
            for e in engines:
                e.stop()
            for rt in workers + [front]:
                await rt.shutdown()

    asyncio.run(main())


# ------------------------------------------------------------ the adapter salt
def test_router_predicts_an_adapter_requests_overlap():
    """The port's engine salts an adapter request's blocks with the
    adapter load's key and reports the key with its load; the router hashes
    an adapter request with that key. So for a base request, an adapter
    request (first cold, then warm), and the adapter reloaded with other
    weights (cold again, then warm), the router's predicted cached tokens
    equal what the worker then reports. Base requests are hashed without a
    salt, as the reference hashes every request."""
    weights = Weights(LORA_MODEL)
    engine = weights.torch_engine(LORA_ENGINE)
    engine.lora.load("a", _adapter_weights(LORA_TCFG, seed=5, scale=2.0))
    prompt = tokens(2, 40, 128)
    w = WorkerWithDpRank(7)

    async def main():
        plane = InProcEventPlane()
        router = await KvRouter(plane, "ns", "be", block_size=16).start()
        engine.kv_publisher = T.KvEventPublisher(plane, "ns", "be", worker_id=7,
                                                 block_size=16)
        engine.metrics_publisher = T.WorkerMetricsPublisher(plane, "ns", "be", worker_id=7)
        steps = []

        async def step(tag, ann):
            await engine.publish_load()
            await asyncio.sleep(0.05)
            d = router.schedule_tokens(prompt, [w], request_id=tag, lora=ann.get("lora"))
            got = await collect(engine, request(False, tag, prompt, 4, ann=ann,
                                                ignore_eos=True))
            router.complete(tag)
            await wait_idle(engine)
            steps.append((tag, d.overlap_blocks * 16, got["cached"]))

        try:
            await step("base", {})
            await step("base-2", {})
            await step("lora", {"lora": "a"})
            await step("lora-2", {"lora": "a"})
            keys = engine.lora.key_map()
            engine.lora.load("a", _adapter_weights(LORA_TCFG, seed=6, scale=2.0))
            assert engine.lora.key_map() != keys
            await step("reloaded", {"lora": "a"})
            await step("reloaded-2", {"lora": "a"})
            await step("base-3", {})
            return steps
        finally:
            await router.stop()
            engine.stop()

    steps = asyncio.run(main())
    assert [(tag, predicted) for tag, predicted, _ in steps] == [
        ("base", 0), ("base-2", 32), ("lora", 0), ("lora-2", 32), ("reloaded", 0),
        ("reloaded-2", 32), ("base-3", 32)]
    for tag, predicted, reported in steps:
        assert predicted == reported, (tag, predicted, reported)
    assert compute_sequence_hashes(prompt, 16) == jhashes(prompt, 16)


async def test_a_worker_without_the_adapter_scores_no_overlap():
    """Two workers hold the prompt's base blocks; only worker 1 reports the
    adapter's key and holds 3 blocks of its salted chain. An adapter
    request scores worker 1 on that chain and worker 2 on nothing; a base
    request scores both on the base chain; an adapter that no worker
    reports scores no one."""
    plane = InProcEventPlane()
    router = await KvRouter(plane, "ns", "be", block_size=4).start()
    prompt = list(range(20))
    key = b"lora\x00a\x00" + bytes(16)
    try:
        pubs = {}
        for wid, adapters in ((1, {"a": key.hex()}), (2, None)):
            pubs[wid] = T.KvEventPublisher(plane, "ns", "be", worker_id=wid, block_size=4)
            await pubs[wid].stored(compute_sequence_hashes(prompt, 4))
            await T.WorkerMetricsPublisher(plane, "ns", "be", worker_id=wid).publish(
                adapters=adapters)
        await pubs[1].stored(compute_sequence_hashes(prompt, 4, extra_key=key)[:3])
        await asyncio.sleep(0.05)
        ws = [WorkerWithDpRank(1), WorkerWithDpRank(2)]
        d = router.schedule_tokens(prompt, ws, request_id="q1", lora="a")
        assert (d.worker, d.overlap_blocks) == (ws[0], 3)
        assert (d.logits[ws[0]], d.logits[ws[1]]) == (2, 5)   # blocks left to prefill
        router.complete("q1")
        base = router.schedule_tokens(prompt, ws)
        assert base.overlap_blocks == 5 and set(base.logits.values()) == {0}
        other = router.schedule_tokens(prompt, ws, lora="b")
        assert other.overlap_blocks == 0
    finally:
        await router.stop()
        await plane.close()


def test_the_kv_frontend_passes_the_adapter_to_the_router():
    """ModelPipeline routes a request with its ``lora`` annotation (None
    without one)."""
    seen = []

    class Spy:
        def schedule_tokens(self, token_ids, **kw):
            seen.append(kw["lora"])
            return SimpleNamespace(worker=WorkerWithDpRank(5), overlap_blocks=0)

    pipe = ModelPipeline.__new__(ModelPipeline)
    pipe.kv_router, pipe.card = Spy(), SimpleNamespace(kv_block_size=4, name=M)
    pipe.client = SimpleNamespace(instances={5: SimpleNamespace(metadata={})})
    pipe._prune_dead_workers = lambda: None
    for ann in ({"lora": "ad"}, {}):
        req = _preq("r", [1, 2, 3])
        req.annotations.update(ann)
        assert pipe._kv_route(req, []) == 5
    assert seen == ["ad", None]


# ------------------------------------------------- the order within one tick
def test_a_block_evicted_and_stored_again_in_one_tick_stays_in_the_view():
    """Within one tick an admission can evict a cached block whose hash
    its own prefill then commits again. Both engines' allocators then hold
    the hash; the port's events leave it in the router's view, while the
    reference publishes the tick's stores before its removals and its view
    loses the block (a divergence the port fixes, ROADMAP Queue 3). A block
    stored and evicted within one tick ends out of both views."""
    weights = Weights(MODEL)

    def run(jax_side):
        plane = RecordingPlane()
        pkg = J if jax_side else T
        engine = (weights.jax_engine if jax_side else weights.torch_engine)(
            dict(ENGINE, num_blocks=4))    # 3 blocks besides the scratch one
        engine.kv_publisher = pkg.KvEventPublisher(plane, "ns", "be", worker_id=3,
                                                   block_size=BS)
        a, views = engine.allocator, []

        def view():
            idx = KvIndexer(block_size=BS)
            for ev in decoded(plane.sent):
                idx.apply(ev)
            return idx.tree.worker_hashes(WorkerWithDpRank(3)), set(a._by_hash)

        async def main():
            ids = a.allocate(3)
            for bid, h in zip(ids, (11, 12, 13)):
                a.commit(bid, h)
            a.release(ids)
            await engine._publish_events()     # tick 1: 11, 12, 13 stored
            ids = a.allocate(2)                # tick 2: evicts 11 and 12 ...
            a.commit(ids[0], 12)               # ... and commits 12 again
            a.release(ids)
            await engine._publish_events()
            views.append(view())
            (bid,) = a.allocate(1)             # tick 3: 14 stored ...
            a.commit(bid, 14)
            a.release([bid])
            a.release(a.allocate(3))           # ... and evicted with 12 and 13
            await engine._publish_events()
            views.append(view())

        try:
            asyncio.run(main())
        finally:
            engine.stop()
        return views

    port, ref = run(False), run(True)
    assert port[0][1] == ref[0][1] == {12, 13}
    assert port[0][0] == {12, 13}
    assert ref[0][0] == {13}              # the reference's view lost 12
    assert port[1] == ref[1] == (set(), set())


def test_kvbm_consolidation_feeds_equal_the_reference(tmp_path):
    """What ``_publish_events`` consolidates with: the tiers' evicted
    hashes (host overflow with and without a disk tier, a clear) and
    ``filter_servable``, equal to the reference's pool's."""
    import numpy as np

    from dynamo_tpu.kvbm.pool import KvbmTiers as JTiers
    from dynamo_tpu_torch.kvbm.pool import KvbmTiers as TTiers

    block = np.arange(64, dtype=np.uint8)
    for disk_bytes in (0, 3 * 64):
        sides = []
        for cls, sub in ((JTiers, "j"), (TTiers, "t")):
            tiers = cls(block_nbytes=64, host_capacity_bytes=4 * 64,
                        disk_capacity_bytes=disk_bytes, disk_path=str(tmp_path / sub))
            log = []
            for h in range(100, 112):
                tiers.store(h, block)
                log.append(tiers.drain_evicted())
            log.append(tiers.filter_servable(list(range(95, 115))))
            tiers.clear()
            log.append(sorted(tiers.drain_evicted()))
            sides.append(log)
        assert sides[1] == sides[0]
        assert any(sides[1][:12]) and sides[1][-1]
