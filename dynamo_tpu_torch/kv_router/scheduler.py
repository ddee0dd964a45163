"""KV-aware worker selection: softmax over a prefill+decode cost.

The port's copy of the reference package's kv_router/scheduler.py, the
counterpart of Dynamo's KvScheduler / DefaultWorkerSelector
(lib/llm/src/kv_router/scheduler.rs:93,511-601):

    logit(w) = overlap_weight * potential_prefill_blocks(w) + decode_blocks(w)

where ``potential_prefill_blocks = query_blocks - overlap_blocks(w)`` (work the
worker would still have to do) and ``decode_blocks`` is its current load. The
*lowest* logit is best; selection samples a softmax over ``-logit / T`` with
temperature T (T=0 -> argmin), tie-breaking toward the worker with the
smallest cached-block footprint to spread the tree.

Scale: ``select_worker`` stays the *exact* scorer; at fleet scale the router
(router.py) calls it on a pruned candidate set instead of every worker. The
scheduler's half of pruning lives here: a registry of known routing targets
plus a load-ordered bucket index answering "the K least-loaded workers" in
O(K log B) without scanning the fleet.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..runtime.config import (
    ENV_ROUTER_POSTINGS_BUCKET,
    ENV_ROUTER_REPLICA_SYNC,
    ENV_ROUTER_SHARDS,
    ENV_ROUTER_TOPK,
    env_bool,
    env_int,
)
from ..runtime.logging import get_logger
from .protocols import OverlapScores, WorkerMetrics, WorkerWithDpRank

log = get_logger("kv_router.scheduler")

# removed-worker tombstones retained against straggler metric reports; far
# above any live fleet's churn window, tiny either way
_TOMBSTONE_CAP = 65536


@dataclasses.dataclass
class KvRouterConfig:
    """Knobs mirroring the reference's KvRouterConfig
    (lib/llm/src/kv_router/kv_router.rs:139-165)."""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    use_kv_events: bool = True            # False -> ApproxKvIndexer
    # publish routing decisions / completions on the event plane and ingest
    # peers', so replicated routers share one load + (approx) prefix view;
    # new replicas catch up via a snapshot handshake (reference:
    # lib/llm/src/kv_router/subscriber.rs, kv_router.rs:163-165)
    replica_sync: bool = dataclasses.field(
        default_factory=lambda: env_bool(ENV_ROUTER_REPLICA_SYNC, False)
    )
    metrics_stale_after_s: float = 10.0
    approx_ttl_s: float = 120.0
    # -- two-stage decision knobs (docs/operations.md "Router scale") -------
    # top-K candidate pruning: union of the K longest-prefix workers
    # (postings index), the K least-loaded workers (load buckets) and any
    # extra-cost standouts is scored exactly; 0 disables pruning. Pruning
    # only engages above 2*K eligible workers, so small fleets are always
    # exact.
    topk_candidates: int = dataclasses.field(
        default_factory=lambda: env_int(ENV_ROUTER_TOPK, 16)
    )
    # hash-bucket shards of the postings index + the replica-sync snapshot
    # protocol (one shard = legacy whole-state snapshots)
    index_shards: int = dataclasses.field(
        default_factory=lambda: env_int(ENV_ROUTER_SHARDS, 1)
    )
    # capped per-block postings size (postings.py)
    postings_bucket: int = dataclasses.field(
        default_factory=lambda: env_int(ENV_ROUTER_POSTINGS_BUCKET, 8)
    )


@dataclasses.dataclass
class SchedulingDecision:
    worker: WorkerWithDpRank
    overlap_blocks: int
    query_blocks: int
    logits: Dict[WorkerWithDpRank, float]

    @property
    def cached_tokens(self) -> int:
        return self.overlap_blocks  # caller multiplies by block_size


class _LoadIndex:
    """Load-ordered worker buckets: ``least(k)`` yields the K lowest-load
    workers in O(K + touched-buckets log B). Buckets are keyed by the
    integer load value; a lazy min-heap orders non-empty bucket keys
    (stale/duplicate keys are dropped on pop). Iteration inside a bucket
    is insertion-ordered — deterministic given a deterministic update
    stream."""

    __slots__ = ("_load", "_buckets", "_heap")

    def __init__(self):
        self._load: Dict[WorkerWithDpRank, int] = {}
        self._buckets: Dict[int, Dict[WorkerWithDpRank, None]] = {}
        self._heap: List[int] = []

    def set(self, w: WorkerWithDpRank, load: int) -> None:
        load = int(load)
        cur = self._load.get(w)
        if cur == load:
            return
        if cur is not None:
            b = self._buckets.get(cur)
            if b is not None:
                b.pop(w, None)
        self._load[w] = load
        b = self._buckets.get(load)
        if b is None:
            b = self._buckets[load] = {}
            heapq.heappush(self._heap, load)
        b[w] = None

    def remove(self, w: WorkerWithDpRank) -> None:
        cur = self._load.pop(w, None)
        if cur is not None:
            b = self._buckets.get(cur)
            if b is not None:
                b.pop(w, None)

    def least(self, k: int, excluded=()) -> List[WorkerWithDpRank]:
        out: List[WorkerWithDpRank] = []
        popped: List[int] = []
        seen_keys: set = set()
        while self._heap and len(out) < k:
            key = heapq.heappop(self._heap)
            if key in seen_keys:
                continue  # duplicate heap entry (bucket re-created): drop
            seen_keys.add(key)
            b = self._buckets.get(key)
            if not b:
                # empty bucket: drop the key AND the bucket dict for good
                self._buckets.pop(key, None)
                continue
            popped.append(key)
            for w in b:
                if w in excluded:
                    continue
                out.append(w)
                if len(out) >= k:
                    break
        for key in popped:
            heapq.heappush(self._heap, key)
        return out

    def __len__(self) -> int:
        return len(self._load)


class KvScheduler:
    def __init__(
        self,
        config: Optional[KvRouterConfig] = None,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.config = config or KvRouterConfig()
        self._rng = random.Random(seed)
        # metric-staleness judgments ride the injected clock
        self._clock = clock
        # live load state, fed by WorkerMetrics events + local bookkeeping
        self._metrics: Dict[WorkerWithDpRank, WorkerMetrics] = {}
        # blocks this router routed but the worker hasn't reported yet
        self._local_decode_blocks: Dict[WorkerWithDpRank, int] = {}
        # every routing target ever registered/observed (insertion-ordered:
        # the candidate universe when callers route by exclusion), plus the
        # load-bucket index answering least_loaded without a fleet scan
        self._workers: Dict[WorkerWithDpRank, None] = {}
        self._loads = _LoadIndex()
        # tombstones: workers explicitly removed (discovery departure,
        # retire, reclaim). A straggler metrics report arriving after the
        # removal must NOT resurrect the worker as a routing candidate —
        # a draining engine keeps publishing until it stops, and a ghost
        # that re-registers at zero-ish load wins the least-loaded prune
        # exactly while real workers honestly report deep queues. Only an
        # explicit re-register (discovery says it's back) clears the mark.
        # Insertion-ordered and bounded: a long-lived router under fleet
        # churn trims the oldest tombstones (a publisher that still lingers
        # months later is not a real failure mode).
        self._removed: Dict[WorkerWithDpRank, None] = {}

    # -- state feeds ---------------------------------------------------------
    def register_worker(self, worker: WorkerWithDpRank) -> None:
        """Make ``worker`` part of the candidate universe (idempotent).
        Discovery/fleet layers call this as instances appear so idle
        workers are reachable through the least-loaded prune path before
        they ever publish metrics or serve a request."""
        self._removed.pop(worker, None)
        if worker not in self._workers:
            self._workers[worker] = None
            self._loads.set(worker, self._raw_load(worker))

    def _raw_load(self, worker: WorkerWithDpRank) -> int:
        """Index load: last reported decode blocks + optimistic local. The
        index deliberately skips the staleness check ``decode_blocks``
        applies — it orders *candidates for exact rescoring*, which then
        prices staleness exactly."""
        m = self._metrics.get(worker)
        reported = (
            m.active_decode_blocks + m.waiting_prefill_blocks
            if m is not None else 0
        )
        return reported + self._local_decode_blocks.get(worker, 0)

    def update_metrics(self, m: WorkerMetrics) -> None:
        if m.worker in self._removed:
            # late report from a removed worker: drop it wholesale
            return
        # staleness is judged against *our* clock: stamp arrival time rather
        # than trusting the producer's wall clock (cross-host skew would
        # silently disable the load term)
        m.ts = self._clock()
        self._metrics[m.worker] = m
        # worker's own report supersedes our optimistic local estimate —
        # it covers BOTH admitted work (active_decode_blocks) and its
        # still-queued backlog (waiting_prefill_blocks), so zeroing the
        # local charges never hides accepted-but-waiting requests
        self._local_decode_blocks[m.worker] = 0
        self._workers.setdefault(m.worker, None)
        self._loads.set(
            m.worker, m.active_decode_blocks + m.waiting_prefill_blocks
        )

    def adapter_key(self, worker: WorkerWithDpRank, name: str) -> Optional[bytes]:
        """The prefix-cache key of adapter ``name`` on ``worker``, from its
        last report (None: not loaded there, or never reported)."""
        m = self._metrics.get(worker)
        key = (m.adapters or {}).get(name) if m is not None else None
        return bytes.fromhex(key) if key else None

    def add_local_load(self, worker: WorkerWithDpRank, blocks: int) -> None:
        if worker in self._removed:
            # a charge can race the removal (decision in flight while
            # discovery retires the worker): never resurrect the candidate
            return
        self._local_decode_blocks[worker] = self._local_decode_blocks.get(worker, 0) + blocks
        self._workers.setdefault(worker, None)
        self._loads.set(worker, self._raw_load(worker))

    def sub_local_load(self, worker: WorkerWithDpRank, blocks: int) -> None:
        if worker not in self._workers:
            # late release for a removed worker (an in-flight request
            # completing after remove_worker): drop the residue instead of
            # resurrecting a dead worker as a zero-load routing candidate
            self._local_decode_blocks.pop(worker, None)
            return
        self._local_decode_blocks[worker] = max(
            0, self._local_decode_blocks.get(worker, 0) - blocks
        )
        self._loads.set(worker, self._raw_load(worker))

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        self._metrics.pop(worker, None)
        self._local_decode_blocks.pop(worker, None)
        self._workers.pop(worker, None)
        self._loads.remove(worker)
        self._removed[worker] = None
        while len(self._removed) > _TOMBSTONE_CAP:
            self._removed.pop(next(iter(self._removed)))

    def decode_blocks(self, worker: WorkerWithDpRank) -> int:
        m = self._metrics.get(worker)
        reported = 0
        if m is not None and (
            self.config.metrics_stale_after_s <= 0
            or self._clock() - m.ts < self.config.metrics_stale_after_s
        ):
            reported = m.active_decode_blocks + m.waiting_prefill_blocks
        return reported + self._local_decode_blocks.get(worker, 0)

    # -- the prune-stage feeds (router.py) -----------------------------------
    def worker_count(self) -> int:
        return len(self._workers)

    def known_workers(self) -> List[WorkerWithDpRank]:
        return list(self._workers)

    def least_loaded(self, k: int, excluded=()) -> List[WorkerWithDpRank]:
        return self._loads.least(k, excluded)

    # -- selection -----------------------------------------------------------
    def select_worker(
        self,
        candidates: Sequence[WorkerWithDpRank],
        overlaps: OverlapScores,
        query_blocks: int,
        tree_sizes: Optional[Dict[WorkerWithDpRank, int]] = None,
        extra_costs: Optional[Dict[WorkerWithDpRank, float]] = None,
        fetchable: Optional[Dict[WorkerWithDpRank, float]] = None,
    ) -> SchedulingDecision:
        """``extra_costs`` adds a per-candidate cost in BLOCK units to the
        logit — the transfer-cost-aware term (NetKV-style): disagg routing
        passes each prefill candidate's estimated wire time for the KV it
        would have to ship, normalized by the per-block prefill time, so a
        candidate behind a slow wire loses to one a device hop away even at
        equal queue depth.

        ``fetchable`` is the directory-aware term (kvbm/directory.py): per
        candidate, how many of the query's blocks it could onboard from a
        peer's G2/G3 tier cheaper than recomputing — in EFFECTIVE block
        units, i.e. already discounted by the fetch/recompute cost ratio
        (ops/costs.fetch_vs_recompute), so a fleet-hot prefix shrinks a
        cold worker's potential-prefill term without ever counting a
        fetched block as free."""
        if not candidates:
            raise ValueError("no candidate workers")
        w = self.config.overlap_score_weight
        logits: Dict[WorkerWithDpRank, float] = {}
        for cand in candidates:
            overlap = overlaps.scores.get(cand, 0)
            potential_prefill = max(0, query_blocks - overlap)
            if fetchable:
                # a block can't be both locally cached and discounted again:
                # the fetchable term only shrinks what overlap left behind
                potential_prefill = max(
                    0.0, potential_prefill - fetchable.get(cand, 0.0)
                )
            logits[cand] = (
                w * potential_prefill + self.decode_blocks(cand)
                + (extra_costs.get(cand, 0.0) if extra_costs else 0.0)
            )

        chosen = self._sample(logits, tree_sizes or {})
        return SchedulingDecision(
            worker=chosen,
            overlap_blocks=overlaps.scores.get(chosen, 0),
            query_blocks=query_blocks,
            logits=logits,
        )

    def _sample(
        self, logits: Dict[WorkerWithDpRank, float], tree_sizes: Dict[WorkerWithDpRank, int]
    ) -> WorkerWithDpRank:
        temp = self.config.router_temperature
        items = sorted(logits.items(), key=lambda kv: (kv[1], tree_sizes.get(kv[0], 0), kv[0]))
        if temp <= 0.0:
            best_logit = items[0][1]
            best = [wk for wk, lg in items if lg == best_logit]
            if len(best) == 1:
                return best[0]
            # tie-break: fewest cached blocks spreads load across the fleet
            return min(best, key=lambda wk: (tree_sizes.get(wk, 0), wk))
        # softmax over negative cost (lower cost -> higher probability)
        mx = max(-lg / temp for _, lg in items)
        weights = [math.exp(-lg / temp - mx) for _, lg in items]
        total = sum(weights)
        r = self._rng.random() * total
        acc = 0.0
        for (wk, _), wt in zip(items, weights):
            acc += wt
            if r <= acc:
                return wk
        return items[-1][0]
