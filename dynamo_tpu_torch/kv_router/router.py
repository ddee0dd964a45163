"""KvRouter: ties indexer + scheduler + event-plane subscriber into one
routing service the frontend pipeline (or a standalone router process) uses.

The port's copy of the reference package's kv_router/router.py, the
counterpart of Dynamo's KvRouter/KvScheduler service side
(lib/llm/src/kv_router/{kv_router,scheduler,subscriber}.rs). ``schedule()``
takes a tokenized request, hashes it into blocks, queries the prefix index,
and returns a (worker_id, dp_rank, overlap) decision; active-request
bookkeeping feeds the load term while worker metrics are in flight.

The decision is two-stage at fleet scale:

1. *Prune*: the K workers with the longest cached prefix (capped sharded
   postings, ``RadixTree.top_prefix_workers``) unioned with the K
   least-loaded workers (``KvScheduler.least_loaded`` load buckets) and any
   extra-cost standouts — O(chain + K log W), no fleet scan.
2. *Exact*: the unchanged ``select_worker`` softmax over that pruned set,
   with restricted-but-exact overlap scores (``find_matches_for``), so the
   transfer-cost and SLA terms ride along unmodified.

Pruning engages only above ``2 * topk_candidates`` eligible workers; small
fleets always score exactly, and ``topk_candidates=0`` disables it. Callers
may pass an explicit ``candidates`` list (legacy, O(fleet) to build) or —
the sublinear path — register workers once (``register_worker``) and route
by ``excluded`` set only.

Replica sync (config.replica_sync, reference subscriber.rs): every routing
decision/completion is published on ``kv.sync.<ns>.<component>``; peer
routers ingest them so their load (and, in approx mode, prefix) views agree.
A router that starts late sends a snapshot request on the same topic and the
first peer to answer ships its indexer state + in-flight load table. With
``index_shards > 1`` catch-up is per hash-bucket shard: one request and one
answer per shard, so no peer ever serializes its whole tree in one message
and different shards may be served by different peers.

Adapter requests (the port's own, ROADMAP Queue 3): the port's engine salts
an adapter request's blocks with the adapter load's ``cache_key``, and
each worker reports its ``{adapter: key}`` map with its load
(``WorkerMetrics.adapters``). A request naming an adapter is hashed once
for each distinct key among the candidates and each worker is scored on
its own key's chain; a worker without the adapter scores 0. Requests
without one take the reference's path unchanged.

``recorder`` (runtime/recorder.py) captures every ingested KV event as the
reference's ``{"kind": "kv_event", "event": ...}`` lines.
"""

from __future__ import annotations

import asyncio
import functools
import heapq
import random
import uuid
from typing import Dict, List, Optional, Sequence, Set

from ..llm.model_card import _IMAGE_TOKEN_ID as IMAGE_TOKEN_ID
from ..runtime import codec
from ..runtime import metrics as M
from ..runtime.clock import WALL, Clock
from ..runtime.event_plane.base import EventPlane, Subscription
from ..runtime.logging import get_logger
from ..tokens import compute_sequence_hashes
from .indexer import ApproxKvIndexer, KvIndexer
from .protocols import (
    OverlapScores,
    RouterEvent,
    WorkerMetrics,
    WorkerWithDpRank,
    block_set_view,
)
from .publisher import events_topic, metrics_topic
from .scheduler import KvRouterConfig, KvScheduler, SchedulingDecision

log = get_logger("kv_router.router")


def sync_topic(namespace: str, component: str) -> str:
    return f"kv.sync.{namespace}.{component}"


class KvRouter:
    def __init__(
        self,
        event_plane: EventPlane,
        namespace: str,
        component: str,
        block_size: int = 16,
        config: Optional[KvRouterConfig] = None,
        seed: Optional[int] = None,
        metrics: Optional[M.MetricsScope] = None,
        clock: Optional[Clock] = None,
        recorder=None,
    ):
        self.config = config or KvRouterConfig()
        # optional runtime.recorder.Recorder: the ingested KV-event stream as
        # JSONL, for replay into another router
        self.recorder = recorder
        # prefix-cache effectiveness on /metrics: tokens the chosen worker
        # already holds per routing decision (the reference's kv-hit-rate
        # signal); None = no registry attached (standalone/unit use)
        self._hit_tokens = (
            metrics.counter(
                M.KV_HIT_TOKENS,
                "prompt tokens matched in the chosen worker's prefix cache",
            )
            if metrics is not None else None
        )
        self.block_size = block_size
        self.namespace = namespace
        self.component = component
        self._plane = event_plane
        # injected time source: metric staleness, approx TTLs and the
        # snapshot-answer jitter all ride it
        self._clock = clock if clock is not None else WALL
        # seeded rng for the snapshot-answer jitter below: a pinned ``seed``
        # makes replica-sync timing reproducible
        self._rng = random.Random(seed)
        self.scheduler = KvScheduler(
            self.config, seed=seed, clock=self._clock.time
        )
        self.indexer: KvIndexer | ApproxKvIndexer
        if self.config.use_kv_events:
            self.indexer = KvIndexer(
                block_size,
                shards=self.config.index_shards,
                postings_bucket=self.config.postings_bucket,
            )
        else:
            self.indexer = ApproxKvIndexer(
                block_size,
                ttl_s=self.config.approx_ttl_s,
                shards=self.config.index_shards,
                postings_bucket=self.config.postings_bucket,
                clock=self._clock.time,
            )
        self._subs: List[Subscription] = []
        self._tasks: List[asyncio.Task] = []
        # request_id -> (worker, blocks) for free() on completion
        self._active: Dict[str, tuple] = {}
        # prune-vs-exact decision counters (deterministic)
        self.pruned_decisions = 0
        self.exact_decisions = 0
        # replica sync state
        self.router_id = uuid.uuid4().hex
        self._remote_active: Dict[tuple, tuple] = {}  # (router, req) -> (worker, blocks)
        self.synced_from_peer = False
        self._synced_shards: Set[int] = set()
        # frees with no matching active entry during the startup window are
        # remembered as tombstones, so a snapshot listing the same request
        # (built before the free) doesn't add phantom in-flight load
        self._free_tombstones: set = set()
        self._tombstone_deadline = 0.0
        # (requester, shard) pairs whose snapshot someone already answered
        # (reply dedup; shard None = legacy whole-state snapshots)
        self._snapshots_seen: set = set()

    async def start(self) -> "KvRouter":
        if self.config.use_kv_events:
            ev_sub = await self._plane.subscribe(events_topic(self.namespace, self.component))
            self._subs.append(ev_sub)
            self._tasks.append(asyncio.create_task(self._event_loop(ev_sub)))
        m_sub = await self._plane.subscribe(metrics_topic(self.namespace, self.component))
        self._subs.append(m_sub)
        self._tasks.append(asyncio.create_task(self._metrics_loop(m_sub)))
        if self.config.replica_sync:
            s_sub = await self._plane.subscribe(sync_topic(self.namespace, self.component))
            self._subs.append(s_sub)
            self._tasks.append(asyncio.create_task(self._sync_loop(s_sub)))
            self._tombstone_deadline = asyncio.get_running_loop().time() + 5.0
            shards = max(1, self.config.index_shards)
            if shards > 1:
                # per-shard catch-up: peers answer shard-by-shard, and the
                # in-flight load table rides the shard-0 answer only
                for i in range(shards):
                    await self._publish_sync(
                        {"kind": "snapshot_request", "shard": i,
                         "shards": shards}
                    )
            else:
                await self._publish_sync({"kind": "snapshot_request"})
        return self

    # -- the candidate universe ----------------------------------------------
    def register_worker(self, worker: WorkerWithDpRank) -> None:
        """Add a routing target to the scheduler's universe (idempotent).
        Required for candidate-free routing (``candidates=None``): callers
        register instances as discovery sees them and afterwards pass only
        per-request ``excluded`` sets — O(K) per decision, not O(fleet)."""
        self.scheduler.register_worker(worker)

    async def _event_loop(self, sub: Subscription) -> None:
        assert isinstance(self.indexer, KvIndexer)
        topic = events_topic(self.namespace, self.component)
        async for got, payload in sub:
            # subscriptions match by prefix: a prefill pool's component
            # (``backend_prefill``) extends the decode pool's (``backend``),
            # and its events are not this pool's (ROADMAP Queue 3)
            if got != topic:
                continue
            try:
                obj = codec.unpackb(payload)
                self.indexer.apply(RouterEvent.from_obj(obj))
                if self.recorder is not None:
                    self.recorder.record({"kind": "kv_event", "event": obj})
            except Exception:
                log.exception("bad router event")

    async def _metrics_loop(self, sub: Subscription) -> None:
        topic = metrics_topic(self.namespace, self.component)
        async for got, payload in sub:
            if got != topic:   # another pool's, whose component extends ours
                continue
            try:
                m = WorkerMetrics.from_obj(codec.unpackb(payload))
                self.scheduler.update_metrics(m)
            except Exception:
                log.exception("bad metrics event")

    # -- replica sync --------------------------------------------------------
    async def _publish_sync(self, obj: dict) -> None:
        obj["router"] = self.router_id
        await self._plane.publish(
            sync_topic(self.namespace, self.component),
            codec.packb(obj),
        )

    def _publish_sync_soon(self, obj: dict) -> None:
        """Fire-and-forget from sync code paths (schedule_tokens/complete)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (unit tests driving the router synchronously)
        t = loop.create_task(self._publish_sync(obj))
        self._tasks.append(t)
        t.add_done_callback(lambda t: self._tasks.remove(t) if t in self._tasks else None)

    async def _sync_loop(self, sub: Subscription) -> None:
        topic = sync_topic(self.namespace, self.component)
        async for got, payload in sub:
            if got != topic:   # another pool's, whose component extends ours
                continue
            try:
                obj = codec.unpackb(payload)
                if obj.get("router") == self.router_id:
                    continue
                self._apply_sync(obj)
            except Exception:
                log.exception("bad sync event")

    def _apply_sync(self, obj: dict) -> None:
        kind = obj.get("kind")
        if kind == "route":
            worker = WorkerWithDpRank.from_obj(obj["worker"])
            blocks = int(obj["blocks"])
            key = (obj["router"], obj["request_id"])
            # peer re-route (migration retry): release the superseded
            # attempt's charge, mirroring schedule_tokens' own bookkeeping
            prev = self._remote_active.pop(key, None)
            if prev is not None:
                self.scheduler.sub_local_load(*prev)
            self._remote_active[key] = (worker, blocks)
            self.scheduler.add_local_load(worker, blocks)
            if isinstance(self.indexer, ApproxKvIndexer) and obj.get("hashes"):
                self.indexer.process_routed_request(list(obj["hashes"]), worker)
        elif kind == "free":
            entry = self._remote_active.pop((obj["router"], obj["request_id"]), None)
            if entry is not None:
                self.scheduler.sub_local_load(*entry)
            elif (
                not self.synced_from_peer
                and asyncio.get_running_loop().time() < self._tombstone_deadline
            ):
                # a free racing ahead of the snapshot that lists its request:
                # remember it so the snapshot entry is skipped, not leaked
                self._free_tombstones.add((obj["router"], obj["request_id"]))
        elif kind == "snapshot_request":
            self._answer_snapshot_soon(
                obj["router"], obj.get("shard"), obj.get("shards", 1)
            )
        elif kind == "snapshot":
            self._apply_snapshot(obj)

    def _apply_snapshot(self, obj: dict) -> None:
        target = obj.get("for")
        shard = obj.get("shard")  # None = legacy whole-state snapshot
        self._snapshots_seen.add((target, shard))
        if target != self.router_id:
            return
        if shard is None:
            if self.synced_from_peer:
                return
        elif shard in self._synced_shards:
            return
        self._synced_shards.add(shard if shard is not None else 0)
        self.indexer.load_snapshot(obj.get("indexer", {}))
        if shard is None or shard == 0:
            # the in-flight load table is not hash-partitioned: it rides the
            # shard-0 (or legacy whole-state) answer exactly once
            self.synced_from_peer = True
            for rid, req_id, w_obj, blocks in obj.get("active", []):
                worker = WorkerWithDpRank.from_obj(w_obj)
                key = (rid, req_id)
                if rid == self.router_id:
                    # our own route reflected back by a peer's snapshot: the
                    # load already sits in _active, and our future 'free' is
                    # ignored by our own sync loop — adding here would leak
                    continue
                if key in self._free_tombstones or key in self._remote_active:
                    continue
                self._remote_active[key] = (worker, int(blocks))
                self.scheduler.add_local_load(worker, int(blocks))
            self._free_tombstones.clear()
        log.info(
            "router %s synced from peer (shard %s): %d blocks, %d in-flight",
            self.router_id[:8], "all" if shard is None else shard,
            len(self.indexer.tree), len(self._remote_active),
        )

    def _answer_snapshot_soon(
        self, requester: str, shard: Optional[int] = None, num_shards: int = 1
    ) -> None:
        """Reply to a snapshot request after a small jittered delay, skipping
        if another peer's answer for the same (requester, shard) was seen
        meanwhile — without this, every peer ships its full tree for every
        joiner."""
        if not (len(self.indexer.tree) > 0 or self._active or self._remote_active):
            return
        key = (requester, shard)
        self._snapshots_seen.discard(key)

        async def answer() -> None:
            await self._clock.sleep(0.05 + 0.2 * self._rng.random())
            if key in self._snapshots_seen:
                return
            msg = {
                "kind": "snapshot",
                "for": requester,
                "indexer": self.indexer.snapshot(
                    shard=shard, num_shards=num_shards
                ),
            }
            if shard is not None:
                msg["shard"] = shard
                msg["shards"] = num_shards
            if shard is None or shard == 0:
                msg["active"] = [
                    [rid, req_id, w.to_obj(), blocks]
                    for (rid, req_id), (w, blocks) in self._remote_active.items()
                ] + [
                    [self.router_id, req_id, w.to_obj(), blocks]
                    for req_id, (w, blocks) in self._active.items()
                ]
            await self._publish_sync(msg)

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        t = loop.create_task(answer())
        self._tasks.append(t)
        t.add_done_callback(lambda t: self._tasks.remove(t) if t in self._tasks else None)

    # -- the routing decision ------------------------------------------------
    def _decide(
        self,
        candidates: Optional[Sequence[WorkerWithDpRank]],
        excluded,
        extra_costs: Optional[Dict[WorkerWithDpRank, float]],
        match_hashes: Sequence[int],
        query_blocks: int,
        fetchable: Optional[Dict[WorkerWithDpRank, float]] = None,
        overlaps_for=None,
    ) -> SchedulingDecision:
        """The two-stage selection shared by schedule_tokens/score_tokens:
        prune to ~2-3K candidates when the eligible universe is large, then
        run the exact scorer on whatever survived. ``candidates`` None means
        "every registered worker" (the sublinear path); an explicit list is
        honored exactly (and its members are registered as a side effect so
        the load index covers idle workers on later calls).
        ``overlaps_for(pool)``, when given, scores the final pool in place
        of the indexer's match on ``match_hashes`` (an adapter request)."""
        sched = self.scheduler
        excl = excluded if excluded else ()
        k = self.config.topk_candidates
        if candidates is not None:
            for c in candidates:
                sched.register_worker(c)
            n = len(candidates)
        else:
            n = sched.worker_count()
        pool: Optional[List[WorkerWithDpRank]] = None
        pruned = False
        if k > 0 and n > 2 * k:
            prefix_c = self.indexer.top_prefix_workers(match_hashes, k)
            load_c = sched.least_loaded(k, excl)
            extras = (
                heapq.nsmallest(
                    k, extra_costs, key=lambda w: (extra_costs[w], w)
                )
                if extra_costs else ()
            )
            member = None if candidates is None else set(candidates)
            pool_d: Dict[WorkerWithDpRank, None] = {}
            for w in (*prefix_c, *load_c, *extras):
                if w in excl:
                    continue
                if member is not None and w not in member:
                    continue
                pool_d[w] = None
            if pool_d:
                pool = list(pool_d)
                pruned = True
        if pool is None:
            base = candidates if candidates is not None else sched.known_workers()
            pool = [w for w in base if w not in excl] if excl else list(base)
            if not pool:
                # exclusion emptied the pool: a shunned worker beats no
                # worker (the discovery/_candidates fallback semantics);
                # callers that must fail instead pre-check their own
                # instance tables
                pool = list(base)
        if not pool:
            raise ValueError("no candidate workers")
        if pruned:
            self.pruned_decisions += 1
        else:
            self.exact_decisions += 1
        if overlaps_for is not None:
            overlaps = overlaps_for(pool)
        elif pruned:
            overlaps = self.indexer.find_matches_for(pool, match_hashes)
        else:
            overlaps = self.indexer.find_matches(match_hashes)
        tree_sizes = {c: self.indexer.tree.worker_block_count(c) for c in pool}
        return sched.select_worker(
            pool, overlaps, query_blocks=query_blocks,
            tree_sizes=tree_sizes, extra_costs=extra_costs,
            fetchable=fetchable,
        )

    def schedule_tokens(
        self,
        token_ids: Sequence[int],
        candidates: Optional[Sequence[WorkerWithDpRank]] = None,
        request_id: Optional[str] = None,
        cacheable: Optional[bool] = None,
        extra_costs: Optional[Dict[WorkerWithDpRank, float]] = None,
        hashes: Optional[Sequence[int]] = None,
        excluded=None,
        fetchable: Optional[Dict[WorkerWithDpRank, float]] = None,
        lora: Optional[str] = None,
    ) -> SchedulingDecision:
        """Multimodal prompts (image placeholder runs hash identically
        across different images) must not produce overlap estimates or
        enter the approx indexer — the engine never serves their blocks
        from cache. Cacheability is derived from the tokens themselves
        (placeholder sentinel present) unless the caller overrides; the
        LOAD accounting keeps the true block count either way.

        ``hashes`` lets a caller that already hashed the prompt (the
        disagg planner hashes once for scoring AND the transfer handshake)
        skip the re-hash; it must be ``compute_sequence_hashes(token_ids,
        self.block_size)``. ``candidates=None`` routes over every
        registered worker minus ``excluded`` — the O(K) path. ``lora``
        names the request's adapter: each worker is then scored on the
        prompt's chain salted with its own load of the adapter."""
        if cacheable is None:
            cacheable = IMAGE_TOKEN_ID not in token_ids
        if hashes is None:
            hashes = compute_sequence_hashes(token_ids, self.block_size)
        salted: Dict[bytes, List[int]] = {}
        overlaps_for = None
        if lora and cacheable:
            overlaps_for = functools.partial(self._salted_overlaps, token_ids, lora, salted)
        decision = self._decide(
            candidates, excluded, extra_costs,
            match_hashes=(hashes if cacheable and not lora else []),
            query_blocks=len(hashes),
            fetchable=fetchable,
            overlaps_for=overlaps_for,
        )
        if lora:
            # the chosen worker's blocks for this request are its salted
            # chain (none at all without the adapter)
            key = self.scheduler.adapter_key(decision.worker, lora)
            hashes = salted.get(key, []) if key is not None else []
        new_blocks = decision.query_blocks - decision.overlap_blocks
        if self._hit_tokens is not None and decision.overlap_blocks > 0:
            self._hit_tokens.inc(decision.overlap_blocks * self.block_size)
        self.scheduler.add_local_load(decision.worker, new_blocks)
        if request_id is not None:
            # a re-route of the same request (migration retry after worker
            # loss) releases the failed attempt's optimistic charge first —
            # overwriting the entry would leak phantom load onto the dead/
            # flapping worker forever, permanently steering traffic off it
            prev = self._active.pop(request_id, None)
            if prev is not None:
                self.scheduler.sub_local_load(*prev)
            self._active[request_id] = (decision.worker, new_blocks)
        if isinstance(self.indexer, ApproxKvIndexer) and cacheable:
            self.indexer.process_routed_request(hashes, decision.worker)
        if self.config.replica_sync and request_id is not None:
            msg = {
                "kind": "route",
                "request_id": request_id,
                "worker": decision.worker.to_obj(),
                "blocks": new_blocks,
            }
            if isinstance(self.indexer, ApproxKvIndexer):
                msg["hashes"] = list(hashes)
            self._publish_sync_soon(msg)
        return decision

    def _salted_overlaps(
        self,
        token_ids: Sequence[int],
        lora: str,
        salted: Dict[bytes, List[int]],
        pool: Sequence[WorkerWithDpRank],
    ) -> OverlapScores:
        """Overlap of an adapter request on each worker of ``pool``: the
        prompt hashed once per distinct adapter key (kept in ``salted``),
        each worker matched on its own key's chain."""
        by_key: Dict[bytes, List[WorkerWithDpRank]] = {}
        for w in pool:
            key = self.scheduler.adapter_key(w, lora)
            if key is not None:
                by_key.setdefault(key, []).append(w)
        scores: Dict[WorkerWithDpRank, int] = {}
        for key, workers in by_key.items():
            salted[key] = compute_sequence_hashes(token_ids, self.block_size,
                                                  extra_key=key)
            scores.update(self.indexer.find_matches_for(workers, salted[key]).scores)
        return OverlapScores(scores=scores, matched_blocks=max(scores.values(), default=0))

    def score_tokens(
        self,
        token_ids: Sequence[int],
        candidates: Optional[Sequence[WorkerWithDpRank]] = None,
        extra_costs: Optional[Dict[WorkerWithDpRank, float]] = None,
        hashes: Optional[Sequence[int]] = None,
        excluded=None,
        fetchable: Optional[Dict[WorkerWithDpRank, float]] = None,
    ) -> SchedulingDecision:
        """Stateless pick: same overlap+load scoring as schedule_tokens but
        NO side effects — no optimistic load charge, no in-flight tracking,
        no approx-index update. For observers that only answer "where would
        this go?" (the endpoint picker, deploy/epp.py): they have no
        completion signal, so an optimistic charge could never be released
        and would drift the scheduler into anti-affinity noise. Worker load
        still tracks reality through the published WorkerMetrics. A caller
        that DOES dispatch on the decision follows up with
        :meth:`commit_route`. ``hashes`` skips the re-hash (pass [] for
        uncacheable prompts — overlap is then ignored but the load term
        keeps the true block count via ``token_ids``)."""
        if hashes is None:
            hashes = compute_sequence_hashes(token_ids, self.block_size)
        query_blocks = max(
            len(hashes), len(token_ids) // self.block_size
        )
        return self._decide(
            candidates, excluded, extra_costs,
            match_hashes=hashes, query_blocks=query_blocks,
            fetchable=fetchable,
        )

    def commit_route(
        self, decision: SchedulingDecision, hashes: Sequence[int] = (),
    ) -> None:
        """Apply the routing bookkeeping ``schedule_tokens`` would have
        done for a decision obtained via :meth:`score_tokens`, once the
        caller has actually dispatched on it: optimistic load charge,
        prefix-hit metric, approx-index route record. Plan-then-maybe-
        deflect callers (the disagg planner) score first so an abandoned
        plan leaves zero phantom state."""
        new_blocks = decision.query_blocks - decision.overlap_blocks
        if self._hit_tokens is not None and decision.overlap_blocks > 0:
            self._hit_tokens.inc(decision.overlap_blocks * self.block_size)
        self.scheduler.add_local_load(decision.worker, new_blocks)
        if isinstance(self.indexer, ApproxKvIndexer) and hashes:
            self.indexer.process_routed_request(list(hashes), decision.worker)

    def complete(self, request_id: str) -> None:
        """Request finished: release its optimistic load contribution."""
        entry = self._active.pop(request_id, None)
        if entry is not None:
            worker, blocks = entry
            self.scheduler.sub_local_load(worker, blocks)
            if self.config.replica_sync:
                self._publish_sync_soon({"kind": "free", "request_id": request_id})

    def remove_worker_id(self, worker_id: int) -> None:
        # a dead worker may hold scheduler load without any tree blocks (it
        # was routed to but never published an event), so clear scheduler
        # state for every rank seen in the in-flight tables — and the
        # registered universe, so candidate-free routing never re-picks it
        gone = {w for w in self.indexer.tree.workers() if w.worker_id == worker_id}
        gone.update(
            w for w in self.scheduler.known_workers()
            if w.worker_id == worker_id
        )
        for table in (self._active, self._remote_active):
            gone.update(w for w, _ in table.values() if w.worker_id == worker_id)
        for w in gone:
            self.indexer.remove_worker(w)
            self.scheduler.remove_worker(w)
        self._active = {
            k: v for k, v in self._active.items() if v[0].worker_id != worker_id
        }
        self._remote_active = {
            k: v for k, v in self._remote_active.items() if v[0].worker_id != worker_id
        }

    def view(self) -> dict:
        """The router's view of its workers, as the exit lines print it:
        {"workers": {worker id (hex): block_set_view}, "events_applied",
        "events_dropped"}."""
        tree = self.indexer.tree
        return {
            "workers": {f"{w.worker_id:016x}": block_set_view(tree.worker_hashes(w))
                        for w in sorted(tree.workers())},
            "events_applied": getattr(self.indexer, "events_applied", 0),
            "events_dropped": getattr(self.indexer, "events_dropped", 0),
        }

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for s in self._subs:
            s.cancel()
