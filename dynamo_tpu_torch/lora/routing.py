"""LoRA fleet routing: rendezvous hashing + replica table.

The port's copy of the reference package's lora/routing.py, the
counterpart of Dynamo's RendezvousHasher (lib/llm/src/lora/routing/hrw.rs)
and LoraRoutingTable (routing/table.rs): each adapter name maps to a
deterministic replica set of workers (highest-random-weight hashing, so
adding/removing workers only moves the minimal number of adapters). As in
the reference, no frontend path consults it yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Sequence

from ..kv_router.protocols import WorkerWithDpRank


class RendezvousHasher:
    """HRW: score(name, worker) = blake2b(name || worker); top-k workers by
    score form the replica set (hrw.rs:12-40)."""

    @staticmethod
    def score(lora_name: str, worker: WorkerWithDpRank) -> int:
        h = hashlib.blake2b(
            f"{lora_name}|{worker.worker_id}|{worker.dp_rank}".encode(),
            digest_size=8,
        ).digest()
        return int.from_bytes(h, "big")

    @classmethod
    def rank_workers(
        cls, lora_name: str, workers: Sequence[WorkerWithDpRank]
    ) -> List[WorkerWithDpRank]:
        return sorted(workers, key=lambda w: cls.score(lora_name, w), reverse=True)

    @classmethod
    def replica_set(
        cls, lora_name: str, workers: Sequence[WorkerWithDpRank], replicas: int
    ) -> List[WorkerWithDpRank]:
        return cls.rank_workers(lora_name, workers)[: max(1, replicas)]


@dataclasses.dataclass
class LoraReplicaConfig:
    """One adapter's placement (table.rs:14-28)."""

    lora_name: str
    replicas: int = 1
    workers: List[WorkerWithDpRank] = dataclasses.field(default_factory=list)


class LoraRoutingTable:
    """name -> replica config; thread-safe (table.rs:30-85)."""

    def __init__(self):
        self._table: Dict[str, LoraReplicaConfig] = {}
        self._lock = threading.Lock()

    def update_allocation(self, name: str, config: LoraReplicaConfig) -> None:
        with self._lock:
            self._table[name] = config

    def get_replica_set(self, name: str) -> Optional[List[WorkerWithDpRank]]:
        with self._lock:
            cfg = self._table.get(name)
            return list(cfg.workers) if cfg else None

    def get_config(self, name: str) -> Optional[LoraReplicaConfig]:
        with self._lock:
            return self._table.get(name)

    def remove_lora(self, name: str) -> Optional[LoraReplicaConfig]:
        with self._lock:
            return self._table.pop(name, None)

    def list_loras(self) -> List[str]:
        with self._lock:
            return sorted(self._table)

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def clear(self) -> None:
        with self._lock:
            self._table.clear()


def allocate(
    names: Sequence[str],
    workers: Sequence[WorkerWithDpRank],
    replicas: int = 1,
) -> LoraRoutingTable:
    """HRW allocation of every adapter onto the worker fleet (the reference's
    create_lora_allocator default path)."""
    table = LoraRoutingTable()
    for name in names:
        table.update_allocation(name, LoraReplicaConfig(
            lora_name=name, replicas=replicas,
            workers=RendezvousHasher.replica_set(name, workers, replicas),
        ))
    return table
