"""KV-routing wire protocols.

The port's copy of the reference package's kv_router/protocols.py.
Everything here crosses the event plane in MessagePack (runtime/codec.py),
so the types are plain dataclasses with dict codecs; a payload is the same
bytes in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

from ..tokens import SequenceHash


@dataclasses.dataclass(frozen=True, order=True)
class WorkerWithDpRank:
    """Routing target: a worker instance plus its data-parallel rank.

    Each dp_rank owns an independent KV pool, so the router must track and
    score them separately (reference scheduler loops every dp_rank,
    lib/llm/src/kv_router/scheduler.rs:543-560)."""

    worker_id: int
    dp_rank: int = 0

    def to_obj(self) -> List[int]:
        return [self.worker_id, self.dp_rank]

    @classmethod
    def from_obj(cls, obj) -> "WorkerWithDpRank":
        return cls(int(obj[0]), int(obj[1]))


class KvEventKind(enum.Enum):
    STORED = "stored"
    REMOVED = "removed"
    CLEARED = "cleared"  # worker dropped its whole cache (restart/reset)


@dataclasses.dataclass
class KvCacheEvent:
    """One mutation of a worker's KV cache, in sequence-hash space."""

    kind: KvEventKind
    # STORED: hashes of newly cached blocks, in order, chained from parent_hash
    block_hashes: List[SequenceHash] = dataclasses.field(default_factory=list)
    parent_hash: Optional[SequenceHash] = None
    # tokens-per-block for sanity checks across heterogeneous pools
    block_size: int = 0

    def to_obj(self) -> Dict:
        return {
            "kind": self.kind.value,
            "block_hashes": self.block_hashes,
            "parent_hash": self.parent_hash,
            "block_size": self.block_size,
        }

    @classmethod
    def from_obj(cls, obj: Dict) -> "KvCacheEvent":
        return cls(
            kind=KvEventKind(obj["kind"]),
            block_hashes=list(obj.get("block_hashes", [])),
            parent_hash=obj.get("parent_hash"),
            block_size=obj.get("block_size", 0),
        )


@dataclasses.dataclass
class RouterEvent:
    """KvCacheEvent stamped with its origin (worker, dp_rank) + sequence no."""

    worker: WorkerWithDpRank
    event: KvCacheEvent
    event_id: int = 0

    def to_obj(self) -> Dict:
        return {"worker": self.worker.to_obj(), "event": self.event.to_obj(), "id": self.event_id}

    @classmethod
    def from_obj(cls, obj: Dict) -> "RouterEvent":
        return cls(
            worker=WorkerWithDpRank.from_obj(obj["worker"]),
            event=KvCacheEvent.from_obj(obj["event"]),
            event_id=obj.get("id", 0),
        )


@dataclasses.dataclass
class OverlapScores:
    """find_matches result: matched-block counts per routing target."""

    scores: Dict[WorkerWithDpRank, int] = dataclasses.field(default_factory=dict)
    # how many leading blocks of the query exist *anywhere* (frequency info)
    matched_blocks: int = 0

    def best(self) -> Tuple[Optional[WorkerWithDpRank], int]:
        if not self.scores:
            return None, 0
        worker = max(self.scores, key=lambda w: (self.scores[w], -w.worker_id))
        return worker, self.scores[worker]


@dataclasses.dataclass
class WorkerMetrics:
    """Per-(worker, dp_rank) load snapshot published by workers.

    Analog of the reference's WorkerMetricsPublisher payload
    (lib/llm/src/kv_router/publisher.rs:957 — active_decode_blocks etc.)."""

    worker: WorkerWithDpRank
    active_decode_blocks: int = 0
    active_prefill_tokens: int = 0
    num_requests_waiting: int = 0
    # blocks the worker has ACCEPTED but not yet admitted (its waiting
    # queue, in block units): the scheduler folds these into the load
    # term so a report can supersede the router's optimistic charges
    # without erasing queued work the worker already owns
    waiting_prefill_blocks: int = 0
    # running SEQUENCES (not blocks): the planner's ITL interpolation is
    # keyed on decode concurrency, which blocks overstate by ctx/block_size
    num_requests_active: int = 0
    total_blocks: int = 0
    ts: float = 0.0
    # the port's own field: {adapter name: prefix-cache key hex} of the
    # worker's loaded adapters (lora/adapters.py cache_key); None from a
    # worker without adapter tables, whose payload is the reference's
    adapters: Optional[Dict[str, str]] = None

    def to_obj(self) -> Dict:
        obj = {
            "worker": self.worker.to_obj(),
            "decode_blocks": self.active_decode_blocks,
            "prefill_tokens": self.active_prefill_tokens,
            "waiting": self.num_requests_waiting,
            "waiting_blocks": self.waiting_prefill_blocks,
            "active": self.num_requests_active,
            "total_blocks": self.total_blocks,
            "ts": self.ts,
        }
        if self.adapters is not None:
            obj["adapters"] = dict(self.adapters)
        return obj

    @classmethod
    def from_obj(cls, obj: Dict) -> "WorkerMetrics":
        return cls(
            worker=WorkerWithDpRank.from_obj(obj["worker"]),
            active_decode_blocks=obj.get("decode_blocks", 0),
            active_prefill_tokens=obj.get("prefill_tokens", 0),
            num_requests_waiting=obj.get("waiting", 0),
            waiting_prefill_blocks=obj.get("waiting_blocks", 0),
            num_requests_active=obj.get("active", 0),
            total_blocks=obj.get("total_blocks", 0),
            ts=obj.get("ts", 0.0),
            adapters=obj.get("adapters"),
        )


def block_set_view(hashes: Iterable[SequenceHash]) -> Dict:
    """A set of block hashes as the exit lines print it: its size, a short
    order-free digest (a worker's prefix cache and the router's view of it
    print the same digest when they hold the same blocks) and the sorted
    hashes themselves, for a diff when they do not."""
    hs = sorted(set(int(h) for h in hashes))
    blob = b"".join(h.to_bytes(8, "big") for h in hs)
    return {"blocks": len(hs), "digest": hashlib.sha256(blob).hexdigest()[:16], "hashes": hs}
