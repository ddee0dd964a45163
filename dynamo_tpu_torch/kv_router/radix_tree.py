"""Prefix index over chained block hashes.

The port's copy of the reference package's kv_router/radix_tree.py.
Because block hashes are *chained* (a block's sequence hash encodes its whole prefix), the "radix tree" flattens to a map
``sequence_hash -> set of workers holding that block`` plus parent links for
eviction bookkeeping: matching a query prefix is a walk down its hash chain
until no worker holds the next block.

Two query tiers serve the two-stage routing decision (scheduler.py):

- ``top_prefix_workers`` — the *prune* stage: a capped sharded postings
  index (postings.py) maintained alongside every mutation answers "up to K
  workers holding the longest prefix" in O(chain + K), never touching a
  full holder set.
- ``find_matches`` / ``find_matches_for`` — the *exact* stage:
  contiguous-match scores over all holders (small fleets) or restricted to
  an already-pruned candidate list (O(chain x K)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ..tokens import SequenceHash
from .postings import ShardedPostings, shard_of
from .protocols import OverlapScores, WorkerWithDpRank


@dataclasses.dataclass
class _Node:
    seq_hash: SequenceHash
    parent: Optional[SequenceHash]
    workers: Set[WorkerWithDpRank] = dataclasses.field(default_factory=set)
    children: Set[SequenceHash] = dataclasses.field(default_factory=set)


class RadixTree:
    def __init__(self, postings_bucket: int = 8, shards: int = 1):
        self._nodes: Dict[SequenceHash, _Node] = {}
        self._worker_blocks: Dict[WorkerWithDpRank, Set[SequenceHash]] = {}
        self.postings = ShardedPostings(shards=shards, bucket=postings_bucket)
        # per-call query instrumentation (pinned by tests): chain nodes
        # touched and holder sets MATERIALIZED by the last find_matches —
        # one intersection per block beyond the first; the first block
        # aliases the node's set read-only, and the old extra per-block
        # ``set(holders)`` copy is gone (so this is matched-1, not ~2x)
        self.last_nodes_visited = 0
        self.last_holder_sets = 0

    # -- mutation -----------------------------------------------------------
    def store(
        self,
        worker: WorkerWithDpRank,
        block_hashes: Iterable[SequenceHash],
        parent_hash: Optional[SequenceHash] = None,
    ) -> None:
        parent = parent_hash
        for sh in block_hashes:
            node = self._nodes.get(sh)
            if node is None:
                node = _Node(sh, parent)
                self._nodes[sh] = node
                if parent is not None and parent in self._nodes:
                    self._nodes[parent].children.add(sh)
            node.workers.add(worker)
            self.postings.add(sh, worker)
            self._worker_blocks.setdefault(worker, set()).add(sh)
            parent = sh

    def remove(self, worker: WorkerWithDpRank, block_hashes: Iterable[SequenceHash]) -> None:
        for sh in block_hashes:
            node = self._nodes.get(sh)
            if node is None:
                continue
            node.workers.discard(worker)
            self.postings.discard(sh, worker, node.workers)
            owned = self._worker_blocks.get(worker)
            if owned is not None:
                owned.discard(sh)
            if not node.workers:
                self._drop_node(sh)

    def _drop_node(self, sh: SequenceHash) -> None:
        node = self._nodes.pop(sh, None)
        if node is None:
            return
        self.postings.drop(sh)
        if node.parent is not None and node.parent in self._nodes:
            self._nodes[node.parent].children.discard(sh)
        # children become orphans; they stay indexed (their own hashes still
        # fully identify their prefix) until their workers remove them

    def remove_worker(self, worker: WorkerWithDpRank) -> None:
        for sh in list(self._worker_blocks.get(worker, ())):
            node = self._nodes.get(sh)
            if node is None:
                continue
            node.workers.discard(worker)
            self.postings.discard(sh, worker, node.workers)
            if not node.workers:
                self._drop_node(sh)
        self._worker_blocks.pop(worker, None)

    def clear_worker(self, worker: WorkerWithDpRank) -> None:
        self.remove_worker(worker)

    # -- query --------------------------------------------------------------
    def find_matches(
        self, block_hashes: List[SequenceHash], early_exit: bool = False
    ) -> OverlapScores:
        """Walk the query's hash chain; count per-worker contiguous matches.

        A worker's score is the number of *leading* blocks of the query it
        holds — only a contiguous prefix saves prefill work.

        The survivor set is never copied: the first block aliases the
        node's holder set read-only, and every later block's ``&`` already
        allocates a fresh set (the per-block ``set(holders)`` copy this
        loop used to make was pure overhead — on a fleet-hot prefix held
        by thousands of workers it was an O(fleet) allocation per block).
        """
        scores: Dict[WorkerWithDpRank, int] = {}
        active: Optional[Set[WorkerWithDpRank]] = None
        matched = 0
        nodes_visited = 0
        holder_sets = 0
        for sh in block_hashes:
            node = self._nodes.get(sh)
            if node is None or not node.workers:
                break
            nodes_visited += 1
            if active is None:
                holders = node.workers  # aliased read-only: no allocation
            else:
                holders = active & node.workers
                holder_sets += 1
            if not holders:
                break
            matched += 1
            for w in holders:
                scores[w] = matched
            active = holders
            if early_exit and len(active) == 1:
                # single candidate: extend its run without set machinery
                (w,) = active
                for sh2 in block_hashes[matched:]:
                    node2 = self._nodes.get(sh2)
                    if node2 is None or w not in node2.workers:
                        break
                    nodes_visited += 1
                    matched += 1
                    scores[w] = matched
                break
        self.last_nodes_visited = nodes_visited
        self.last_holder_sets = holder_sets
        return OverlapScores(scores=scores, matched_blocks=matched)

    def find_matches_for(
        self,
        candidates: Sequence[WorkerWithDpRank],
        block_hashes: List[SequenceHash],
    ) -> OverlapScores:
        """Exact contiguous-match scores restricted to ``candidates``:
        O(chain x |candidates|) membership probes, independent of how many
        other workers hold the prefix. ``matched_blocks`` is the deepest
        contiguous match *among the candidates* (the full-tree depth is
        irrelevant to a decision over this set)."""
        scores: Dict[WorkerWithDpRank, int] = {}
        alive = list(dict.fromkeys(candidates))
        matched = 0
        for sh in block_hashes:
            if not alive:
                break
            node = self._nodes.get(sh)
            if node is None or not node.workers:
                break
            holders = node.workers
            still = [w for w in alive if w in holders]
            if not still:
                break
            matched += 1
            for w in still:
                scores[w] = matched
            alive = still
        return OverlapScores(scores=scores, matched_blocks=matched)

    def top_prefix_workers(
        self, block_hashes: List[SequenceHash], k: int
    ) -> List[WorkerWithDpRank]:
        """Up to ``k`` workers holding the longest indexed prefix of the
        chain, deepest holders first, via the capped postings — O(chain+k),
        no holder-set walks. Approximate in two ways (both repaired by the
        exact rescoring stage): a bucket caps holders per block, and a
        worker posted deep may have evicted an earlier block."""
        if k <= 0 or not block_hashes:
            return []
        depth_hashes: List[SequenceHash] = []
        for sh in block_hashes:
            node = self._nodes.get(sh)
            if node is None or not node.workers:
                break
            depth_hashes.append(sh)
        out: List[WorkerWithDpRank] = []
        seen: Set[WorkerWithDpRank] = set()
        for sh in reversed(depth_hashes):
            for w in self.postings.posted(sh):
                if w not in seen:
                    seen.add(w)
                    out.append(w)
                    if len(out) >= k:
                        return out
        return out

    # -- snapshot -----------------------------------------------------------
    def snapshot(
        self, shard: Optional[int] = None, num_shards: int = 1
    ) -> dict:
        """Serializable tree state (reference: the router state snapshot
        gated by KvRouterConfig's snapshot threshold, kv_router.rs:163-165).
        With ``shard`` set, only nodes in that hash bucket are shipped —
        the per-shard replica-sync pieces (router.py) merge back into the
        identical full tree (postings rebuild incrementally via store)."""
        return {
            "nodes": [
                [n.seq_hash, n.parent, [w.to_obj() for w in sorted(n.workers)]]
                for n in self._nodes.values()
                if shard is None or shard_of(n.seq_hash, num_shards) == shard
            ]
        }

    def merge_snapshot(self, obj: dict) -> None:
        """Add every (node, worker) pair from a snapshot to this tree;
        existing state is kept (see KvIndexer.load_snapshot for why merge)."""
        for seq_hash, parent, workers in obj.get("nodes", []):
            for w in workers:
                self.store(WorkerWithDpRank.from_obj(w), [seq_hash], parent)
        # nodes arrive in arbitrary order; store() can only link a child to a
        # parent that already exists, so re-link in a second pass
        for node in self._nodes.values():
            if node.parent is not None and node.parent in self._nodes:
                self._nodes[node.parent].children.add(node.seq_hash)

    @classmethod
    def from_snapshot(cls, obj: dict) -> "RadixTree":
        tree = cls()
        tree.merge_snapshot(obj)
        return tree

    # -- introspection ------------------------------------------------------
    def worker_block_count(self, worker: WorkerWithDpRank) -> int:
        return len(self._worker_blocks.get(worker, ()))

    def worker_hashes(self, worker: WorkerWithDpRank) -> Set[SequenceHash]:
        """The blocks the index credits to ``worker`` (a copy)."""
        return set(self._worker_blocks.get(worker, ()))

    def workers(self) -> List[WorkerWithDpRank]:
        return list(self._worker_blocks)

    def __len__(self) -> int:
        return len(self._nodes)
