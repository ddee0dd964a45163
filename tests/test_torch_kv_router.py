"""The port's KV router (dynamo_tpu_torch/kv_router, lora/routing.py)
against the reference package's, on the CPU.

- Parity: seeded numpy event streams (stores of shared-prefix chains,
  removals, clears, from 6 workers over 2 dp ranks) go through both
  packages' ``RadixTree`` / ``KvIndexer``, ``ApproxKvIndexer`` (on an
  injected clock) and ``KvRouter`` (its ``KvScheduler`` at temperature 0
  and 0.7 with one seed, exact and pruned): overlap scores, prefix
  candidates, decisions and their logits, and the snapshot bytes must be
  EQUAL (MessagePack through msgpack on the reference's side and the
  port's codec on the port's; no tolerance).
- Publishers: ``KvEventPublisher`` and ``WorkerMetricsPublisher`` write
  the reference's payload bytes for the same events.
- Mirrored: the reference's ``test_kv_router.py::
  test_router_end_to_end_over_event_plane``, the tests of
  ``test_router_replica.py`` that need no mocker and those of
  ``test_router_pruning.py`` but its micro-bench, on the port's classes.
- ``lora/routing.py``: ranks, replica sets and allocations equal the
  reference's on ``tests/test_lora.py``'s cases.
"""

import asyncio
import random

import msgpack
import numpy as np
import pytest

from dynamo_tpu import kv_router as J
from dynamo_tpu.lora import routing as jlora
from dynamo_tpu.runtime import InProcEventPlane as JInProcEventPlane
from dynamo_tpu_torch import kv_router as T
from dynamo_tpu_torch.kv_router import (
    ApproxKvIndexer,
    KvCacheEvent,
    KvEventKind,
    KvEventPublisher,
    KvIndexer,
    KvRouter,
    KvRouterConfig,
    RadixTree,
    RouterEvent,
    WorkerMetricsPublisher,
    WorkerWithDpRank,
)
from dynamo_tpu_torch.kv_router.scheduler import _LoadIndex
from dynamo_tpu_torch.lora import routing as tlora
from dynamo_tpu_torch.runtime import InProcEventPlane
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.tokens import compute_sequence_hashes

BS = 4
W0 = WorkerWithDpRank(0)
W1 = WorkerWithDpRank(1)


def W(i, r=0):
    return WorkerWithDpRank(i, r)


def hashes(tokens, bs=BS):
    return compute_sequence_hashes(tokens, bs)


def jpack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def keyed(scores) -> dict:
    """Overlap scores of either package as {(worker_id, dp_rank): blocks}."""
    return {(w.worker_id, w.dp_rank): s for w, s in scores.items()}


def test_package_exports_are_the_references():
    assert T.__all__ == J.__all__


# ---------------------------------------------------------------------------
# seeded event streams through both packages
# ---------------------------------------------------------------------------

WORKERS = [(i, r) for i in range(6) for r in range(2)]


def event_stream(seed: int, n: int = 300):
    """(worker, kind, hashes, parent) events over shared-prefix chains:
    each store is a chain's prefix (or its continuation from a parent),
    each removal some of the worker's blocks, now and then a clear."""
    rng = np.random.default_rng(seed)
    chains = []
    for g in range(10):
        base = rng.integers(0, 5000, size=int(rng.integers(4, 12)) * BS).tolist()
        chains.append(compute_sequence_hashes(base, BS))
        if g % 3 == 0:  # a branch sharing this chain's first blocks
            cut = int(rng.integers(1, len(base) // BS))
            tail = rng.integers(0, 5000, size=3 * BS).tolist()
            chains.append(compute_sequence_hashes(base[:cut * BS] + tail, BS))
    held = {w: [] for w in WORKERS}
    out = []
    for _ in range(n):
        w = WORKERS[int(rng.integers(len(WORKERS)))]
        r = rng.random()
        if r < 0.6 or not held[w]:
            ch = chains[int(rng.integers(len(chains)))]
            lo = int(rng.integers(0, 2)) * int(rng.integers(1, len(ch)))
            hi = int(rng.integers(lo + 1, len(ch) + 1))
            out.append((w, "stored", ch[lo:hi], ch[lo - 1] if lo else None))
            held[w] += ch[lo:hi]
        elif r < 0.95:
            k = int(rng.integers(1, len(held[w]) + 1))
            pick = [held[w][int(i)] for i in rng.choice(len(held[w]), size=k, replace=False)]
            out.append((w, "removed", pick, None))
            held[w] = [h for h in held[w] if h not in set(pick)]
        else:
            out.append((w, "cleared", [], None))
            held[w] = []
    return out, chains


def router_event(pkg, w, kind, hs, parent, eid):
    ev = pkg.KvCacheEvent(pkg.KvEventKind(kind), list(hs), parent,
                          BS if kind == "stored" else 0)
    return pkg.RouterEvent(pkg.WorkerWithDpRank(*w), ev, eid)


def queries(chains, seed, n=20):
    rng = np.random.default_rng(seed + 1000)
    out = [list(c) for c in chains]
    for _ in range(n):
        c = chains[int(rng.integers(len(chains)))]
        k = int(rng.integers(1, len(c) + 1))
        out.append(list(c[:k]) + compute_sequence_hashes(
            rng.integers(0, 5000, size=2 * BS).tolist(), BS))
    return out


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indexer_on_event_streams_equals_reference(seed, shards):
    """Exact: after every 25 events, the overlap scores, matched depth,
    restricted scores, prefix candidates and snapshot (whole and per
    shard) of both indexers are equal."""
    events, chains = event_stream(seed)
    j = J.KvIndexer(block_size=BS, shards=shards, postings_bucket=3)
    t = KvIndexer(block_size=BS, shards=shards, postings_bucket=3)
    cands_j = [J.WorkerWithDpRank(*w) for w in WORKERS[::3]]
    cands_t = [WorkerWithDpRank(*w) for w in WORKERS[::3]]
    for n, (w, kind, hs, parent) in enumerate(events, 1):
        j.apply(router_event(J, w, kind, hs, parent, n))
        t.apply(router_event(T, w, kind, hs, parent, n))
        if n % 25:
            continue
        for q in queries(chains, seed + n):
            a, b = j.find_matches(q), t.find_matches(q)
            assert keyed(b.scores) == keyed(a.scores)
            assert b.matched_blocks == a.matched_blocks
            assert keyed(t.find_matches_for(cands_t, q).scores) == keyed(
                j.find_matches_for(cands_j, q).scores)
            assert [w.to_obj() for w in t.top_prefix_workers(q, 4)] == [
                w.to_obj() for w in j.top_prefix_workers(q, 4)]
        assert codec.packb(t.snapshot()) == jpack(j.snapshot())
        for i in range(shards):
            assert codec.packb(t.snapshot(shard=i, num_shards=shards)) == jpack(
                j.snapshot(shard=i, num_shards=shards))
    assert (t.events_applied, t.events_dropped) == (j.events_applied, j.events_dropped)
    assert t.block_count() == j.block_count()
    # a replayed event is dropped by both
    w, kind, hs, parent = events[0]
    j.apply(router_event(J, w, "stored", hs, None, 1))
    t.apply(router_event(T, w, "stored", hs, None, 1))
    assert (t.events_applied, t.events_dropped) == (j.events_applied, j.events_dropped)


def test_snapshot_round_trip_between_packages():
    """A snapshot the reference encodes loads into the port's indexer and
    back: both trees then answer every query alike."""
    events, chains = event_stream(7)
    j = J.KvIndexer(block_size=BS)
    for n, (w, kind, hs, parent) in enumerate(events, 1):
        j.apply(router_event(J, w, kind, hs, parent, n))
    t = KvIndexer(block_size=BS)
    t.load_snapshot(codec.unpackb(jpack(j.snapshot())))
    back = J.KvIndexer(block_size=BS)
    back.load_snapshot(msgpack.unpackb(codec.packb(t.snapshot()), raw=False))
    for q in queries(chains, 7):
        assert keyed(t.find_matches(q).scores) == keyed(j.find_matches(q).scores)
        assert keyed(back.find_matches(q).scores) == keyed(j.find_matches(q).scores)


def test_approx_indexer_equals_reference_on_an_injected_clock():
    """Routed requests with TTL 5 s at seeded times: scores after each
    prune, and snapshot bytes at the same instants, equal."""
    rng = np.random.default_rng(3)
    _, chains = event_stream(3)
    now = [0.0]
    j = J.ApproxKvIndexer(block_size=BS, ttl_s=5.0, shards=2, clock=lambda: now[0])
    t = ApproxKvIndexer(block_size=BS, ttl_s=5.0, shards=2, clock=lambda: now[0])
    for step in range(120):
        now[0] += float(rng.exponential(0.4))
        ch = chains[int(rng.integers(len(chains)))]
        k = int(rng.integers(1, len(ch) + 1))
        w = WORKERS[int(rng.integers(len(WORKERS)))]
        j.process_routed_request(list(ch[:k]), J.WorkerWithDpRank(*w))
        t.process_routed_request(list(ch[:k]), WorkerWithDpRank(*w))
        q = list(chains[int(rng.integers(len(chains)))])
        assert keyed(t.find_matches(q).scores) == keyed(j.find_matches(q).scores)
        if step % 20 == 0:
            for i in range(2):
                assert codec.packb(t.snapshot(shard=i, num_shards=2)) == jpack(
                    j.snapshot(shard=i, num_shards=2))


class FrozenClock:
    """A clock both routers share: ``now`` seconds, no sleeping."""

    def __init__(self):
        self.now = 1000.0

    def time(self) -> float:
        return self.now

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(0)


@pytest.mark.parametrize("topk", [16, 3])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_router_decisions_equal_reference(temperature, topk):
    """The same events, metrics and requests through both routers (seed
    11): each decision's worker, overlap, query blocks and logits, the
    load each router charges, its pruned / exact counts and its indexer
    snapshot are equal. ``topk`` 3 engages the pruned path over the 12
    workers."""
    events, chains = event_stream(5, n=150)
    clock = FrozenClock()
    cfg = dict(router_temperature=temperature, topk_candidates=topk, overlap_score_weight=1.5)
    jr = J.KvRouter(JInProcEventPlane(), "ns", "be", block_size=BS,
                    config=J.KvRouterConfig(**cfg), seed=11, clock=clock)
    tr = KvRouter(InProcEventPlane(), "ns", "be", block_size=BS,
                  config=KvRouterConfig(**cfg), seed=11, clock=clock)
    for w in WORKERS:
        jr.register_worker(J.WorkerWithDpRank(*w))
        tr.register_worker(WorkerWithDpRank(*w))
    rng = np.random.default_rng(9)
    for n, (w, kind, hs, parent) in enumerate(events, 1):
        jr.indexer.apply(router_event(J, w, kind, hs, parent, n))
        tr.indexer.apply(router_event(T, w, kind, hs, parent, n))
    for i, w in enumerate(WORKERS):
        m = dict(active_decode_blocks=int(rng.integers(0, 30)),
                 waiting_prefill_blocks=int(rng.integers(0, 5)), ts=1.0)
        jr.scheduler.update_metrics(J.WorkerMetrics(J.WorkerWithDpRank(*w), **m))
        tr.scheduler.update_metrics(T.WorkerMetrics(WorkerWithDpRank(*w), **m))
    live = []
    for step in range(60):
        ch = chains[int(rng.integers(len(chains)))]
        k = int(rng.integers(1, len(ch) + 1))
        toks = rng.integers(0, 5000, size=(k + 1) * BS).tolist()
        # a prompt whose hash chain is ch[:k] followed by fresh blocks: build
        # it through the hashes the router is given
        hs = list(ch[:k]) + compute_sequence_hashes(toks, BS)[k:]
        excluded = {WORKERS[int(rng.integers(len(WORKERS)))]} if step % 5 == 0 else set()
        rid = f"r{step}"
        a = jr.schedule_tokens(toks, request_id=rid, hashes=hs,
                               excluded={J.WorkerWithDpRank(*w) for w in excluded})
        b = tr.schedule_tokens(toks, request_id=rid, hashes=hs,
                               excluded={WorkerWithDpRank(*w) for w in excluded})
        assert b.worker.to_obj() == a.worker.to_obj()
        assert (b.overlap_blocks, b.query_blocks) == (a.overlap_blocks, a.query_blocks)
        assert keyed(b.logits) == keyed(a.logits)
        live.append(rid)
        if rng.random() < 0.4:
            done = live.pop(int(rng.integers(len(live))))
            jr.complete(done)
            tr.complete(done)
        if step % 20 == 19:
            gone = WORKERS[int(rng.integers(len(WORKERS)))][0]
            jr.remove_worker_id(gone)
            tr.remove_worker_id(gone)
    for w in WORKERS:
        assert tr.scheduler.decode_blocks(WorkerWithDpRank(*w)) == jr.scheduler.decode_blocks(
            J.WorkerWithDpRank(*w))
    assert (tr.pruned_decisions, tr.exact_decisions) == (jr.pruned_decisions,
                                                         jr.exact_decisions)
    if topk == 3:
        assert tr.pruned_decisions > 0
    assert codec.packb(tr.indexer.snapshot()) == jpack(jr.indexer.snapshot())


# ---------------------------------------------------------------------------
# publisher payloads
# ---------------------------------------------------------------------------


class RecordingPlane:
    def __init__(self):
        self.sent = []

    async def publish(self, topic, payload):
        self.sent.append((topic, payload))


async def test_publisher_payloads_are_the_references_bytes():
    """Stored (with and without a parent, hashes past 2**63), removed,
    cleared and metrics events: topic and payload bytes equal."""
    jp, tp = RecordingPlane(), RecordingPlane()
    hs = hashes(list(range(40)))
    assert any(h >= 1 << 63 for h in hs + hashes(list(range(1000, 1400))))
    big = hashes(list(range(1000, 1400)))
    sides = []
    for pkg, plane in ((J, jp), (T, tp)):
        kv = pkg.KvEventPublisher(plane, "dynamo", "backend", worker_id=(1 << 62) + 5,
                                  dp_rank=1, block_size=BS)
        met = pkg.WorkerMetricsPublisher(plane, "dynamo", "backend", worker_id=7,
                                         clock=lambda: 1234.5)
        await kv.stored(hs)
        await kv.stored(big[3:], parent_hash=big[2])
        await kv.removed(big[5:9])
        await kv.cleared()
        await met.publish(active_decode_blocks=12, active_prefill_tokens=300,
                          num_requests_waiting=2, num_requests_active=3,
                          total_blocks=2048, waiting_prefill_blocks=4)
        await met.publish()
        sides.append(kv)
    assert tp.sent == jp.sent
    assert [t for t, _ in tp.sent] == ["kv.events.dynamo.backend"] * 4 + [
        "kv.metrics.dynamo.backend"] * 2
    assert sides[1].counts == {"stored": 2, "removed": 1, "cleared": 1}


# ---------------------------------------------------------------------------
# lora/routing.py against the reference
# ---------------------------------------------------------------------------


def test_lora_rendezvous_ranks_equal_reference():
    workers = [(i, r) for i in range(1, 9) for r in range(2)]
    for name in ("my-lora", "l1", "l2", "l3", "adapter-ä"):
        jw = [J.WorkerWithDpRank(*w) for w in workers]
        tw = [WorkerWithDpRank(*w) for w in workers]
        assert [w.to_obj() for w in tlora.RendezvousHasher.rank_workers(name, tw)] == [
            w.to_obj() for w in jlora.RendezvousHasher.rank_workers(name, jw)]
        for k in (0, 1, 2, 5):
            assert [w.to_obj() for w in tlora.RendezvousHasher.replica_set(name, tw, k)] == [
                w.to_obj() for w in jlora.RendezvousHasher.replica_set(name, jw, k)]


def test_lora_routing_table_equals_reference():
    """tests/test_lora.py's case: deterministic, minimal movement when a
    worker leaves, and the allocated table."""
    tw = [WorkerWithDpRank(i) for i in range(1, 6)]
    jw = [J.WorkerWithDpRank(i) for i in range(1, 6)]
    a = tlora.RendezvousHasher.replica_set("my-lora", tw, 2)
    assert a == tlora.RendezvousHasher.replica_set("my-lora", tw, 2)
    gone = next(w for w in tw if w not in a)
    reduced = [w for w in tw if w != gone]
    assert tlora.RendezvousHasher.replica_set("my-lora", reduced, 2) == a
    tt = tlora.allocate(["l1", "l2", "l3"], tw, replicas=2)
    jt = jlora.allocate(["l1", "l2", "l3"], jw, replicas=2)
    assert tt.list_loras() == jt.list_loras() == ["l1", "l2", "l3"]
    for name in tt.list_loras():
        assert [w.to_obj() for w in tt.get_replica_set(name)] == [
            w.to_obj() for w in jt.get_replica_set(name)]
    assert tt.remove_lora("l2").lora_name == "l2"
    assert len(tt) == 2 and tt.get_replica_set("l2") is None
    tt.clear()
    assert len(tt) == 0


# ---------------------------------------------------------------------------
# mirrored: tests/test_kv_router.py::test_router_end_to_end_over_event_plane
# ---------------------------------------------------------------------------


async def test_router_end_to_end_over_event_plane():
    """Worker publishes KV events + metrics; router routes accordingly."""
    plane = InProcEventPlane()
    router = await KvRouter(plane, "ns", "backend", block_size=4).start()

    pub0 = KvEventPublisher(plane, "ns", "backend", worker_id=0, block_size=4)
    mpub1 = WorkerMetricsPublisher(plane, "ns", "backend", worker_id=1)

    prompt = list(range(32))  # 8 blocks
    await pub0.stored(compute_sequence_hashes(prompt, 4))
    await mpub1.publish(active_decode_blocks=0)
    await asyncio.sleep(0.05)  # let subscriber loops drain

    d = router.schedule_tokens(prompt, [W0, W1], request_id="r1")
    assert d.worker == W0
    assert d.overlap_blocks == 8
    router.complete("r1")

    # worker 0 evicts everything -> new request prefers idle worker by tie-break
    await pub0.cleared()
    await asyncio.sleep(0.05)
    d2 = router.schedule_tokens(list(range(100, 132)), [W0, W1], request_id="r2")
    assert d2.overlap_blocks == 0
    await router.stop()
    await plane.close()


# ---------------------------------------------------------------------------
# mirrored: tests/test_router_replica.py (the tests without a mocker)
# ---------------------------------------------------------------------------


async def drain():
    for _ in range(5):
        await asyncio.sleep(0.01)


async def poll(cond, timeout=3.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        if asyncio.get_running_loop().time() > deadline:
            return False
        await asyncio.sleep(0.02)
    return True


async def test_replica_sync_shares_load_view():
    """Router B sees the load router A routed (reference subscriber.rs)."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        prompt = list(range(32))  # 8 blocks
        d = a.schedule_tokens(prompt, [W0, W1], request_id="r1")
        await drain()
        # B accounts A's in-flight blocks on the same worker
        assert b.scheduler.decode_blocks(d.worker) == 8
        assert a.scheduler.decode_blocks(d.worker) == 8
        # B's next decision avoids the loaded worker
        d2 = b.schedule_tokens(list(range(100, 132)), [W0, W1], request_id="r2")
        assert d2.worker != d.worker
        # completion on A propagates
        a.complete("r1")
        await drain()
        assert b.scheduler.decode_blocks(d.worker) == 0
    finally:
        await a.stop()
        await b.stop()
        await plane.close()


async def test_replica_sync_approx_prefix_stickiness():
    """Approx mode: peers mirror routed prefixes, so the same prompt routed
    through *either* router lands on the same worker."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True, use_kv_events=False)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        prompt = list(range(64))
        d = a.schedule_tokens(prompt, [W0, W1], request_id="r1")
        a.complete("r1")
        await drain()
        d2 = b.schedule_tokens(prompt, [W0, W1], request_id="r2")
        assert d2.worker == d.worker
        assert d2.overlap_blocks > 0
    finally:
        await a.stop()
        await b.stop()
        await plane.close()


async def test_late_joiner_snapshot_catchup():
    """A router that starts after the fleet has state receives a peer
    snapshot: full prefix tree + in-flight load (kv_router.rs:163-165)."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        pub = KvEventPublisher(plane, "ns", "be", worker_id=0, block_size=BS)
        prompt = list(range(32))
        await pub.stored(compute_sequence_hashes(prompt, BS))
        await drain()
        assert len(a.indexer.tree) == 8
        a.schedule_tokens(prompt, [W0, W1], request_id="inflight")

        b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
        assert await poll(lambda: b.synced_from_peer)  # jittered snapshot reply
        assert len(b.indexer.tree) == 8
        # in-flight load came across too: W0 holds the full prefix, so the
        # only load is optimistic prefill bookkeeping (0 new blocks) — check
        # the tables agree instead of a specific number
        assert b.scheduler.decode_blocks(W0) == a.scheduler.decode_blocks(W0)
        # and B routes the same prompt to the same worker A would
        assert (
            b.schedule_tokens(prompt, [W0, W1]).worker
            == a.schedule_tokens(prompt, [W0, W1]).worker
        )
        await b.stop()
    finally:
        await a.stop()
        await plane.close()


async def test_late_joiner_sharded_snapshot_catchup():
    """index_shards > 1: the joiner requests one snapshot per hash-bucket
    shard and the merged pieces equal the peer's whole tree; the in-flight
    load table rides the shard-0 answer exactly once."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True, index_shards=4)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        pub = KvEventPublisher(plane, "ns", "be", worker_id=0, block_size=BS)
        prompt = list(range(64))  # 16 blocks spread across the 4 shards
        await pub.stored(compute_sequence_hashes(prompt, BS))
        await drain()
        assert len(a.indexer.tree) == 16
        a.schedule_tokens(prompt, [W0, W1], request_id="inflight")

        b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
        assert await poll(lambda: len(b._synced_shards) == 4)
        assert b.synced_from_peer  # shard 0 carried the active table
        assert len(b.indexer.tree) == 16
        assert b.scheduler.decode_blocks(W0) == a.scheduler.decode_blocks(W0)
        assert (
            b.schedule_tokens(prompt, [W0, W1]).worker
            == a.schedule_tokens(prompt, [W0, W1]).worker
        )
        await b.stop()
    finally:
        await a.stop()
        await plane.close()


async def test_replica_reroute_releases_peer_charge():
    """A migration retry re-publishes the route for the same request id;
    peers must release the superseded attempt's load, not leak it onto the
    failed worker (the phantom-load regression the HTTP-frontend sim
    scenario exposed)."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        prompt = list(range(32))  # 8 blocks
        d1 = a.schedule_tokens(prompt, [W0, W1], request_id="r1")
        d2 = a.schedule_tokens(prompt, [W0, W1], request_id="r1")  # retry
        assert d2.worker != d1.worker
        await drain()
        # on BOTH routers only the retry's charge remains
        for r in (a, b):
            assert r.scheduler.decode_blocks(d1.worker) == 0
            assert r.scheduler.decode_blocks(d2.worker) == 8
        a.complete("r1")
        await drain()
        assert b.scheduler.decode_blocks(d2.worker) == 0
    finally:
        await a.stop()
        await b.stop()
        await plane.close()


async def test_live_events_survive_snapshot_merge():
    """KV events applied while a snapshot is in flight are merged, not wiped:
    the joiner ends with snapshot blocks AND the live event's blocks."""
    plane = InProcEventPlane()
    cfg = KvRouterConfig(replica_sync=True)
    a = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
    try:
        pub = KvEventPublisher(plane, "ns", "be", worker_id=0, block_size=BS)
        await pub.stored(compute_sequence_hashes(list(range(16)), BS))  # 4 blocks
        await drain()
        b = await KvRouter(plane, "ns", "be", block_size=BS, config=cfg).start()
        # before the (jittered) snapshot reply lands, a fresh event arrives
        # and B applies it live
        await pub.stored(compute_sequence_hashes(list(range(100, 116)), BS))
        assert await poll(lambda: b.synced_from_peer)
        assert await poll(lambda: len(b.indexer.tree) == 8), len(b.indexer.tree)
        await b.stop()
    finally:
        await a.stop()
        await plane.close()


# ---------------------------------------------------------------------------
# mirrored: tests/test_router_pruning.py (all but its micro-bench)
# ---------------------------------------------------------------------------


# postings index


class TestPostings:
    def test_bucket_caps_and_preserves_insertion_order(self):
        tree = RadixTree(postings_bucket=3)
        h = hashes(list(range(8)))  # 2 blocks
        for i in range(6):
            tree.store(W(i), h)
        # only the first 3 storers are posted, in order; holders stay exact
        assert tree.postings.posted(h[0]) == (W(0), W(1), W(2))
        assert len(tree.find_matches(h).scores) == 6

    def test_underflow_refills_sorted_from_holders(self):
        tree = RadixTree(postings_bucket=4)
        h = hashes(list(range(4)))  # 1 block
        for i in range(8):
            tree.store(W(i), h)
        assert tree.postings.posted(h[0]) == (W(0), W(1), W(2), W(3))
        # removing posted workers below half refills deterministically
        tree.remove(W(0), h)
        tree.remove(W(1), h)
        tree.remove(W(2), h)
        posted = tree.postings.posted(h[0])
        assert posted[0] == W(3)
        assert set(posted) <= {W(i) for i in range(3, 8)}
        assert len(posted) == 4  # refilled back to the bucket cap

    def test_drop_node_drops_postings(self):
        tree = RadixTree()
        h = hashes(list(range(4)))
        tree.store(W(1), h)
        tree.remove_worker(W(1))
        assert tree.postings.posted(h[0]) == ()
        assert len(tree.postings) == 0

    def test_top_prefix_workers_deepest_first(self):
        tree = RadixTree()
        h = hashes(list(range(16)))  # 4 blocks
        tree.store(W(1), h[:1])
        tree.store(W(2), h[:2])
        tree.store(W(3), h)          # deepest holder
        got = tree.top_prefix_workers(h, 2)
        assert got[0] == W(3)
        assert len(got) == 2
        # k >= holders returns everyone, deepest first
        assert tree.top_prefix_workers(h, 10) == [W(3), W(2), W(1)]
        assert tree.top_prefix_workers(h, 0) == []
        assert tree.top_prefix_workers([], 5) == []

    def test_sharded_postings_partition_by_hash(self):
        tree = RadixTree(shards=4)
        h = hashes(list(range(64)))  # 16 blocks spread over shards
        tree.store(W(1), h)
        sizes = tree.postings.shard_sizes()
        assert sum(sizes) == len(h)
        assert sum(1 for s in sizes if s > 0) > 1  # actually partitioned
        assert tree.top_prefix_workers(h, 1) == [W(1)]


# ---------------------------------------------------------------------------
# restricted exact matching + the find_matches micro-fix
# ---------------------------------------------------------------------------


class TestFindMatches:
    def _random_tree(self, seed, n_workers=12, groups=6, depth=8):
        rng = random.Random(seed)
        tree = RadixTree()
        chains = []
        for g in range(groups):
            h = hashes([g * 1000 + t for t in range(depth * BS)])
            chains.append(h)
            for w in rng.sample(range(n_workers), rng.randrange(1, n_workers)):
                tree.store(W(w), h[: rng.randrange(1, depth + 1)])
        return tree, chains

    def test_find_matches_for_equals_restricted_full_scores(self):
        for seed in range(5):
            tree, chains = self._random_tree(seed)
            for h in chains:
                full = tree.find_matches(h).scores
                cands = [W(i) for i in range(0, 12, 2)]
                got = tree.find_matches_for(cands, h).scores
                want = {w: s for w, s in full.items() if w in set(cands)}
                assert got == want, (seed, got, want)

    def test_find_matches_one_holder_set_per_block_beyond_first(self):
        """The per-block ``set(holders)`` copy is gone: a 64-block chain
        visits 64 nodes and materializes exactly matched-1 = 63 holder
        sets (the required intersections; the first block aliases the
        node's set read-only). Pre-fix the walk allocated an EXTRA copy
        per matched block — 127 total, each O(fleet) on a fleet-hot
        prefix."""
        tree = RadixTree()
        h = hashes(list(range(64 * BS)))  # 64 blocks
        for i in range(3):
            tree.store(W(i), h)
        m = tree.find_matches(h)
        assert m.matched_blocks == 64
        assert tree.last_nodes_visited == 64
        assert tree.last_holder_sets == 63
        # single-block query: pure alias, zero set allocations
        tree.find_matches(h[:1])
        assert tree.last_holder_sets == 0

    def test_find_matches_semantics_unchanged(self):
        tree = RadixTree()
        h = hashes(list(range(16)))
        tree.store(W(0), h)
        tree.store(W(1), h[:2])
        m = tree.find_matches(h)
        assert m.scores == {W(0): 4, W(1): 2}
        assert m.matched_blocks == 4


# ---------------------------------------------------------------------------
# load index
# ---------------------------------------------------------------------------


class TestLoadIndex:
    def test_least_orders_and_updates(self):
        idx = _LoadIndex()
        for i, load in enumerate([5, 0, 3, 0, 9]):
            idx.set(W(i), load)
        assert idx.least(3) == [W(1), W(3), W(2)]
        idx.set(W(1), 100)                 # busiest now
        assert idx.least(2) == [W(3), W(2)]
        idx.remove(W(3))
        assert idx.least(2) == [W(2), W(0)]

    def test_excluded_and_duplicate_bucket_keys(self):
        idx = _LoadIndex()
        idx.set(W(0), 1)
        idx.set(W(0), 2)
        idx.set(W(1), 1)   # bucket 1 re-created: duplicate heap key
        idx.set(W(2), 1)
        got = idx.least(10)
        assert got == [W(1), W(2), W(0)]
        assert idx.least(10, excluded={W(1)}) == [W(2), W(0)]
        # repeated queries stay stable (heap keys restored)
        assert idx.least(10) == got


# ---------------------------------------------------------------------------
# the pruned decision path
# ---------------------------------------------------------------------------


def _make_router(n_workers, seed, topk, use_kv_events=True):
    cfg = KvRouterConfig(
        topk_candidates=topk, use_kv_events=use_kv_events,
        metrics_stale_after_s=0.0,  # local-load only: no wall-time reads
    )
    router = KvRouter(
        InProcEventPlane(), "t", "be", block_size=BS, config=cfg, seed=seed,
    )
    workers = [W(i) for i in range(n_workers)]
    for w in workers:
        router.register_worker(w)
    return router, workers


def _seed_state(router, workers, seed, groups=8, depth=8, max_load=40):
    rng = random.Random(seed)
    chains = []
    eid = 0
    for g in range(groups):
        h = hashes([g * 1000 + t for t in range(depth * BS)])
        chains.append(h)
        for w in rng.sample(workers, rng.randrange(1, max(2, len(workers) // 2))):
            eid += 1
            router.indexer.apply(RouterEvent(
                w, KvCacheEvent(KvEventKind.STORED, list(h), None, BS), eid,
            ))
    for w in workers:
        load = rng.randrange(0, max_load)
        if load:
            router.scheduler.add_local_load(w, load)
    return chains, rng


class TestPrunedSelection:
    def test_small_fleet_never_prunes(self):
        router, workers = _make_router(8, 0, topk=16)
        _seed_state(router, workers, 0)
        router.score_tokens(list(range(32)))
        assert router.pruned_decisions == 0
        assert router.exact_decisions == 1

    def test_pruned_equals_exact_when_k_covers_fleet(self):
        for n in (8, 24, 64):
            router, workers = _make_router(n, 3, topk=n)
            chains, rng = _seed_state(router, workers, 3)
            for i in range(20):
                toks = [rng.randrange(2000) for _ in range(24)]
                a = router.score_tokens(toks)
                saved = router.config.topk_candidates
                router.config.topk_candidates = 0
                b = router.score_tokens(toks)
                router.config.topk_candidates = saved
                assert a.worker == b.worker

    def test_pruned_pick_within_exact_tie_set(self):
        """Quality parity on fleets <= 64: the pruned winner's exact logit
        equals the exact argmin's logit across seeded random trees/loads —
        prefix-or-load pruning plus exact rescoring does not change what
        the decision optimizes."""
        for n in (40, 48, 64):
            for seed in range(4):
                router, workers = _make_router(n, seed, topk=16)
                chains, rng = _seed_state(router, workers, seed)
                for i in range(25):
                    if rng.random() < 0.5:
                        h = list(rng.choice(chains))
                        toks = None
                    else:
                        toks = [rng.randrange(5000) for _ in range(6 * BS)]
                        h = None
                    kw = dict(hashes=h) if h is not None else {}
                    toks = toks if toks is not None else list(range(6 * BS))
                    pruned = router.score_tokens(toks, **kw)
                    saved = router.config.topk_candidates
                    router.config.topk_candidates = 0
                    exact = router.score_tokens(toks, **kw)
                    router.config.topk_candidates = saved
                    assert router.pruned_decisions > 0
                    best = min(exact.logits.values())
                    got = exact.logits[pruned.worker]
                    assert got == best, (
                        n, seed, i, got, best, pruned.worker, exact.worker,
                    )

    def test_excluded_set_routing_and_fallback(self):
        router, workers = _make_router(6, 0, topk=0)
        d = router.score_tokens(list(range(16)), excluded={workers[0]})
        assert d.worker != workers[0]
        # exclusion covering the whole universe falls back to everyone
        d2 = router.score_tokens(list(range(16)), excluded=set(workers))
        assert d2.worker in workers

    def test_reroute_releases_previous_charge(self):
        """Migration-retry regression: re-scheduling the same request id
        must release the failed attempt's optimistic load, or the dead
        worker keeps phantom load forever and is never routed to again."""
        router, workers = _make_router(2, 0, topk=0)
        w0, w1 = workers
        d1 = router.schedule_tokens(list(range(32)), request_id="r1")
        first = d1.worker
        other = w1 if first == w0 else w0
        d2 = router.schedule_tokens(list(range(32)), request_id="r1")
        assert d2.worker == other  # retry steers to the other worker
        # the first attempt's charge is gone; only the retry's remains
        assert router.scheduler.decode_blocks(first) == 0
        assert router.scheduler.decode_blocks(other) == 8
        router.complete("r1")
        assert router.scheduler.decode_blocks(other) == 0

    def test_remove_worker_id_clears_registered_universe(self):
        router, workers = _make_router(4, 0, topk=0)
        router.remove_worker_id(2)
        assert W(2) not in router.scheduler.known_workers()
        assert router.scheduler.worker_count() == 3

    def test_late_complete_does_not_resurrect_removed_worker(self):
        """An in-flight request completing AFTER its worker was removed
        must not re-insert the dead worker into the load index as a
        zero-load candidate that least_loaded keeps picking."""
        router, workers = _make_router(4, 0, topk=0)
        d = router.schedule_tokens(list(range(32)), request_id="r1")
        router.remove_worker_id(d.worker.worker_id)
        router.complete("r1")  # late release: the worker is already gone
        # a stray release reaching the scheduler directly (peer sync) too
        router.scheduler.sub_local_load(d.worker, 8)
        assert d.worker not in router.scheduler.known_workers()
        assert d.worker not in router.scheduler.least_loaded(10)
        assert router.scheduler.decode_blocks(d.worker) == 0

    def test_late_metrics_report_does_not_resurrect_removed_worker(self):
        """A draining engine keeps publishing metrics after discovery
        removed it; the report must not re-register the ghost — it would
        win the least-loaded prune at near-zero load exactly while live
        workers honestly report deep queues. An explicit re-register
        (discovery says it's back) lifts the tombstone."""
        from dynamo_tpu_torch.kv_router import WorkerMetrics

        router, workers = _make_router(4, 0, topk=0)
        router.remove_worker_id(2)
        router.scheduler.update_metrics(
            WorkerMetrics(W(2), active_decode_blocks=0)
        )
        assert W(2) not in router.scheduler.known_workers()
        assert W(2) not in router.scheduler.least_loaded(10)
        # the charge path can race a removal too
        router.scheduler.add_local_load(W(2), 8)
        assert W(2) not in router.scheduler.known_workers()
        # discovery re-admits the worker: candidate again, reports land
        router.scheduler.register_worker(W(2))
        router.scheduler.update_metrics(
            WorkerMetrics(W(2), active_decode_blocks=3)
        )
        assert W(2) in router.scheduler.known_workers()
        assert router.scheduler.decode_blocks(W(2)) == 3

    def test_approx_indexer_pruned_path(self):
        router, workers = _make_router(80, 1, topk=8, use_kv_events=False)
        toks = list(range(8 * BS))
        d = router.schedule_tokens(toks, request_id="a1")
        router.complete("a1")  # release the optimistic charge
        # the approx index learned the route; the pruned prefix path finds it
        d2 = router.score_tokens(toks)
        assert router.pruned_decisions >= 1
        assert d2.overlap_blocks == 8
        assert d2.worker == d.worker


# ---------------------------------------------------------------------------
# clock injection
# ---------------------------------------------------------------------------


def test_approx_indexer_injected_clock():
    now = [0.0]
    idx = ApproxKvIndexer(block_size=BS, ttl_s=10.0, clock=lambda: now[0])
    h = hashes(list(range(16)))
    idx.process_routed_request(h, W(0))
    assert idx.find_matches(h).scores[W(0)] == 4
    now[0] = 11.0
    assert W(0) not in idx.find_matches(h).scores


def test_scheduler_injected_clock_staleness():
    from dynamo_tpu_torch.kv_router import WorkerMetrics
    from dynamo_tpu_torch.kv_router.scheduler import KvScheduler

    now = [100.0]
    sched = KvScheduler(
        KvRouterConfig(metrics_stale_after_s=5.0), clock=lambda: now[0]
    )
    sched.update_metrics(WorkerMetrics(W(0), active_decode_blocks=50))
    assert sched.decode_blocks(W(0)) == 50
    now[0] = 106.0  # stale on the injected clock, no wall time involved
    assert sched.decode_blocks(W(0)) == 0


# ---------------------------------------------------------------------------
# sharded snapshots
# ---------------------------------------------------------------------------


class TestShardedSnapshots:
    def test_tree_shard_pieces_compose_to_full(self):
        tree = RadixTree()
        for g in range(5):
            h = hashes([g * 100 + t for t in range(24)])
            tree.store(W(g), h)
            tree.store(W(g + 10), h[:3])
        shards = 4
        pieces = [tree.snapshot(shard=i, num_shards=shards) for i in range(shards)]
        assert sum(len(p["nodes"]) for p in pieces) == len(tree)
        merged = RadixTree()
        for p in pieces:
            merged.merge_snapshot(p)
        for g in range(5):
            h = hashes([g * 100 + t for t in range(24)])
            assert merged.find_matches(h).scores == tree.find_matches(h).scores

    def test_indexer_shard_snapshots_merge(self):
        a = KvIndexer(block_size=BS, shards=4)
        h = hashes(list(range(64)))
        a.apply(RouterEvent(W(1), KvCacheEvent(KvEventKind.STORED, h, None, BS), 7))
        b = KvIndexer(block_size=BS, shards=4)
        for i in range(4):
            b.load_snapshot(a.snapshot(shard=i, num_shards=4))
        assert b.find_matches(h).scores == a.find_matches(h).scores
        assert b._last_event_id[W(1)] == 7

    def test_approx_shard_snapshots_merge(self):
        now = [0.0]
        a = ApproxKvIndexer(block_size=BS, shards=3, clock=lambda: now[0])
        h = hashes(list(range(32)))
        a.process_routed_request(h, W(2))
        b = ApproxKvIndexer(block_size=BS, shards=3, clock=lambda: now[0])
        for i in range(3):
            b.load_snapshot(a.snapshot(shard=i, num_shards=3))
        assert b.find_matches(h).scores == {W(2): 8}
