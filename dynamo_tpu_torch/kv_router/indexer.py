"""KV indexers: event-driven (exact) and approximate (TTL-simulated).

The port's copy of the reference package's kv_router/indexer.py: the exact
``KvIndexer`` fed by worker events, and ``ApproxKvIndexer`` with its TTL
prune (``--no-kv-events``).

Both are built on the same RadixTree, so both expose the two-stage query
surface the router's pruned decision path needs (radix_tree.py):
``top_prefix_workers`` (capped postings, O(chain+K)) for the prune stage
and ``find_matches_for`` (restricted exact scores) for the rescore stage.
Snapshots are shard-addressable (``shard``/``num_shards``) so replica sync
can ship router state one hash bucket at a time (router.py).
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Optional

from ..runtime.logging import get_logger
from ..tokens import SequenceHash
from .postings import shard_of
from .protocols import KvEventKind, OverlapScores, RouterEvent, WorkerWithDpRank
from .radix_tree import RadixTree

log = get_logger("kv_router.indexer")


class KvIndexer:
    """Exact prefix index built from worker KV-cache events."""

    def __init__(
        self,
        block_size: int = 16,
        shards: int = 1,
        postings_bucket: int = 8,
    ):
        self.block_size = block_size
        self.tree = RadixTree(postings_bucket=postings_bucket, shards=shards)
        self.shards = max(1, shards)
        self._last_event_id: Dict[WorkerWithDpRank, int] = {}
        self.events_applied = 0
        self.events_dropped = 0

    def apply(self, ev: RouterEvent) -> None:
        last = self._last_event_id.get(ev.worker)
        if ev.event_id and last is not None and ev.event_id <= last:
            self.events_dropped += 1  # replay/duplicate
            return
        if ev.event_id:
            self._last_event_id[ev.worker] = ev.event_id
        kind = ev.event.kind
        if kind == KvEventKind.STORED:
            if ev.event.block_size and ev.event.block_size != self.block_size:
                log.warning(
                    "worker %s block_size %d != router %d; ignoring event",
                    ev.worker, ev.event.block_size, self.block_size,
                )
                self.events_dropped += 1
                return
            self.tree.store(ev.worker, ev.event.block_hashes, ev.event.parent_hash)
        elif kind == KvEventKind.REMOVED:
            self.tree.remove(ev.worker, ev.event.block_hashes)
        elif kind == KvEventKind.CLEARED:
            self.tree.clear_worker(ev.worker)
        self.events_applied += 1

    def find_matches(self, block_hashes: List[SequenceHash]) -> OverlapScores:
        return self.tree.find_matches(block_hashes)

    def find_matches_for(self, candidates, block_hashes) -> OverlapScores:
        return self.tree.find_matches_for(candidates, block_hashes)

    def top_prefix_workers(self, block_hashes, k: int):
        return self.tree.top_prefix_workers(block_hashes, k)

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        self.tree.remove_worker(worker)
        self._last_event_id.pop(worker, None)

    def remove_worker_id(self, worker_id: int) -> None:
        for w in [w for w in self.tree.workers() if w.worker_id == worker_id]:
            self.remove_worker(w)

    def block_count(self) -> int:
        return len(self.tree)

    def snapshot(
        self, shard: Optional[int] = None, num_shards: int = 1
    ) -> dict:
        """Full state, or one hash-bucket shard of it. Event-id high-water
        marks ride every shard piece (they are per-worker, not per-hash)
        and merge idempotently via max."""
        return {
            "tree": self.tree.snapshot(shard=shard, num_shards=num_shards),
            "last_event_id": [
                [w.to_obj(), eid] for w, eid in self._last_event_id.items()
            ],
        }

    def load_snapshot(self, obj: dict) -> None:
        """MERGE a peer's snapshot into local state (new-replica catch-up).

        Merging — not replacing — means KV events applied live while the
        snapshot was in flight are never wiped (events and sync ride separate
        topics with no cross-topic ordering), and per-shard pieces compose:
        merging every shard of a peer equals merging its whole-tree
        snapshot. The cost is soft: a block the worker REMOVED between
        snapshot-build and arrival is resurrected until the worker's next
        removal/clear — a stale routing hint, not a correctness loss.
        Event-id high-water marks take the max per worker so the replay
        guard stays tight."""
        self.tree.merge_snapshot(obj.get("tree", {}))
        for w_obj, eid in obj.get("last_event_id", []):
            w = WorkerWithDpRank.from_obj(w_obj)
            self._last_event_id[w] = max(self._last_event_id.get(w, 0), int(eid))


class ApproxKvIndexer:
    """Eventless fallback: the router *assumes* whatever it routed is cached.

    On each routed request, insert its block hashes for the chosen worker with
    a TTL; a lazy min-heap prune expires entries. Accuracy degrades under
    eviction pressure, but no worker cooperation is required. TTL expiry
    rides the injected ``clock``.
    """

    def __init__(
        self,
        block_size: int = 16,
        ttl_s: float = 120.0,
        shards: int = 1,
        postings_bucket: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.block_size = block_size
        self.ttl_s = ttl_s
        self.tree = RadixTree(postings_bucket=postings_bucket, shards=shards)
        self.shards = max(1, shards)
        self._clock = clock
        # (expiry_time, worker, seq_hash)
        self._expiry_heap: List = []
        self._expiry: Dict = {}  # (worker, seq_hash) -> latest expiry

    def process_routed_request(
        self, block_hashes: List[SequenceHash], worker: WorkerWithDpRank,
        now: Optional[float] = None,
    ) -> None:
        now = self._clock() if now is None else now
        expiry = now + self.ttl_s
        self.tree.store(worker, block_hashes, None)
        for sh in block_hashes:
            self._expiry[(worker, sh)] = expiry
            heapq.heappush(self._expiry_heap, (expiry, worker, sh))
        self._prune(now)

    def find_matches(
        self, block_hashes: List[SequenceHash], now: Optional[float] = None
    ) -> OverlapScores:
        self._prune(self._clock() if now is None else now)
        return self.tree.find_matches(block_hashes)

    def find_matches_for(
        self, candidates, block_hashes, now: Optional[float] = None
    ) -> OverlapScores:
        self._prune(self._clock() if now is None else now)
        return self.tree.find_matches_for(candidates, block_hashes)

    def top_prefix_workers(
        self, block_hashes, k: int, now: Optional[float] = None
    ):
        self._prune(self._clock() if now is None else now)
        return self.tree.top_prefix_workers(block_hashes, k)

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        self.tree.remove_worker(worker)
        self._expiry = {k: v for k, v in self._expiry.items() if k[0] != worker}

    def snapshot(
        self, shard: Optional[int] = None, num_shards: int = 1
    ) -> dict:
        now = self._clock()
        return {
            "ttl": [
                [w.to_obj(), sh, max(0.0, exp - now)]
                for (w, sh), exp in self._expiry.items()
                if shard is None or shard_of(sh, num_shards) == shard
            ]
        }

    def load_snapshot(self, obj: dict) -> None:
        now = self._clock()
        for w_obj, sh, remaining in obj.get("ttl", []):
            w = WorkerWithDpRank.from_obj(w_obj)
            expiry = now + float(remaining)
            # never shorten a fresher TTL learned from live route sync while
            # the snapshot was in flight (stale heap entries are skipped by
            # _prune's current-expiry check)
            if expiry <= self._expiry.get((w, sh), 0.0):
                continue
            self.tree.store(w, [sh], None)
            self._expiry[(w, sh)] = expiry
            heapq.heappush(self._expiry_heap, (expiry, w, sh))

    def _prune(self, now: float) -> None:
        while self._expiry_heap and self._expiry_heap[0][0] <= now:
            expiry, worker, sh = heapq.heappop(self._expiry_heap)
            current = self._expiry.get((worker, sh))
            if current is None or current > expiry:
                continue  # stale heap entry: re-inserted later with fresh TTL
            del self._expiry[(worker, sh)]
            self.tree.remove(worker, [sh])
