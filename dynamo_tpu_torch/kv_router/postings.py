"""Sharded bucketed prefix->worker postings: the routing prune index.

The port's copy of the reference package's kv_router/postings.py: alongside the exact
``RadixTree`` holder sets, every indexed block hash keeps a small capped
"postings" list of workers (a bucket, default 8). Answering "which K
workers hold the longest cached prefix of this hash chain" then walks the
chain once and drains postings deepest-first — O(chain + K) — instead of
intersecting full holder sets, which on a fleet-hot prefix is O(fleet)
per block.

Postings are *approximate by construction*: a bucket caps how many
holders of one block are routable via the prefix path (the load path and
exact rescoring keep selection quality, scheduler.py). Ordering is
insertion order — deterministic given a deterministic event stream. On removal a bucket that underflows below half
refills from the node's full holder set in sorted order, so a hot prefix
whose early holders evict stays reachable.

Shards partition the postings by hash bucket (``seq_hash % shards``).
Each shard is an independent map with no cross-shard links, so replicated
frontends can snapshot/merge router state shard-by-shard
(``KvRouter`` sync protocol) and a multi-threaded/process port can place
shards behind separate locks — there is no single hot structure.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List

from ..tokens import SequenceHash


def shard_of(seq_hash: SequenceHash, num_shards: int) -> int:
    """Stable hash-bucket shard id (SequenceHash is an int; no process-
    seeded ``hash()`` — replicas must agree on the partition)."""
    if num_shards <= 1:
        return 0
    return int(seq_hash) % num_shards


class ShardedPostings:
    def __init__(self, shards: int = 1, bucket: int = 8):
        self.shards = max(1, int(shards))
        self.bucket = max(1, int(bucket))
        # per shard: seq_hash -> insertion-ordered {worker: None} (<= bucket)
        self._maps: List[Dict[SequenceHash, Dict]] = [
            {} for _ in range(self.shards)
        ]

    def _map(self, sh: SequenceHash) -> Dict[SequenceHash, Dict]:
        return self._maps[shard_of(sh, self.shards)]

    # -- maintenance (driven by RadixTree mutations) -------------------------
    def add(self, sh: SequenceHash, worker) -> None:
        m = self._map(sh)
        posted = m.get(sh)
        if posted is None:
            posted = m[sh] = {}
        if worker not in posted and len(posted) < self.bucket:
            posted[worker] = None

    def discard(self, sh: SequenceHash, worker, holders: Iterable) -> None:
        """Remove ``worker`` from the bucket; refill from the node's full
        ``holders`` (sorted, so the refill is deterministic) when the
        bucket underflows below half while un-posted holders remain."""
        m = self._map(sh)
        posted = m.get(sh)
        if posted is None or worker not in posted:
            return
        del posted[worker]
        if len(posted) * 2 < self.bucket:
            # nsmallest keeps the refill deterministic at O(holders log
            # bucket) — a full sort would be O(fleet log fleet) per refill
            # on exactly the fleet-hot blocks this index exists to avoid
            # scanning
            for w in heapq.nsmallest(self.bucket, holders):
                if len(posted) >= self.bucket:
                    break
                if w != worker:
                    posted.setdefault(w, None)
        if not posted:
            del m[sh]

    def drop(self, sh: SequenceHash) -> None:
        self._map(sh).pop(sh, None)

    # -- queries -------------------------------------------------------------
    def posted(self, sh: SequenceHash) -> tuple:
        posted = self._map(sh).get(sh)
        return tuple(posted) if posted else ()

    def shard_sizes(self) -> List[int]:
        return [len(m) for m in self._maps]

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps)
