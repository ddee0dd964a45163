"""RouterService: KV-aware routing served over the request plane.

The port's copy of the reference package's router/service.py, the
counterpart of Dynamo's standalone router (components/src/dynamo/router:
a KvPushRouter exposed as its own component so N frontends or prefill
orchestrators can share one routing brain). The service watches the target
component's instance registry for candidates, runs a full KvRouter
(indexer + scheduler, optionally replica-synced with other router
instances), and answers on ``{component}-router/route``:

    {"op": "route", "request_id": ..., "token_ids": [...], "lora": name?}
        -> {"worker_id", "dp_rank", "overlap_blocks", "cached_tokens"}
    {"op": "free", "request_id": ...}            -> {"ok": true}
    {"op": "state"}                              -> introspection snapshot

``lora`` is the port's own key: an adapter request's overlap is counted on
each worker's salted chain (kv_router/router.py). Without it, requests and
answers are the reference's.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, List, Optional

from ..kv_router import KvRouter, KvRouterConfig, WorkerWithDpRank
from ..runtime.component import Client, RouterMode
from ..runtime.distributed import DistributedRuntime
from ..runtime.engine import Context


class RouterService:
    def __init__(
        self,
        runtime: DistributedRuntime,
        namespace: str = "dynamo",
        component: str = "backend",
        endpoint: str = "generate",
        block_size: int = 16,
        config: Optional[KvRouterConfig] = None,
        recorder=None,
    ):
        self.runtime = runtime
        self.recorder = recorder
        self.namespace = namespace
        self.component = component
        self.endpoint = endpoint
        self.block_size = block_size
        self.config = config or KvRouterConfig()
        self.client: Optional[Client] = None
        self.router: Optional[KvRouter] = None
        self.served = None

    async def start(self) -> "RouterService":
        target = (
            self.runtime.namespace(self.namespace)
            .component(self.component)
            .endpoint(self.endpoint)
        )
        self.client = await target.client(RouterMode.ROUND_ROBIN)
        self.router = await KvRouter(
            self.runtime.event_plane,
            self.namespace,
            self.component,
            block_size=self.block_size,
            config=self.config,
            recorder=self.recorder,
            # a standalone router's overlap hits land on its own /metrics
            metrics=self.runtime.metrics,
        ).start()
        ep = (
            self.runtime.namespace(self.namespace)
            .component(f"{self.component}-router")
            .endpoint("route")
        )
        self.served = await ep.serve(
            self.handle, metadata={"router_id": self.router.router_id}
        )
        return self

    def _candidates(self) -> List[WorkerWithDpRank]:
        assert self.client is not None
        cands: List[WorkerWithDpRank] = []
        for iid, inst in self.client.instances.items():
            dp = int(inst.metadata.get("data_parallel_size", 1) or 1)
            for r in range(dp):
                cands.append(WorkerWithDpRank(iid, r))
        return cands

    def _prune_dead_workers(self) -> None:
        assert self.router is not None and self.client is not None
        live = set(self.client.instances)
        # sweep the router's registered universe, not a known-set delta: a
        # stale metrics event auto-registers workers in the scheduler
        # (update_metrics), so a removed worker can be resurrected after
        # its one-shot delta removal and must be swept out again
        for w in self.router.scheduler.known_workers():
            if w.worker_id not in live:
                self.router.remove_worker_id(w.worker_id)

    async def handle(self, request: Any, context: Context) -> AsyncIterator[Any]:
        op = request.get("op", "route")
        if op == "route":
            self._prune_dead_workers()
            cands = self._candidates()
            if not cands:
                yield {"error": "no workers available"}
                return
            decision = self.router.schedule_tokens(
                list(request["token_ids"]), cands,
                request_id=request.get("request_id"), lora=request.get("lora"),
            )
            yield {
                "worker_id": decision.worker.worker_id,
                "dp_rank": decision.worker.dp_rank,
                "overlap_blocks": decision.overlap_blocks,
                "cached_tokens": decision.overlap_blocks * self.block_size,
            }
        elif op == "free":
            self.router.complete(request["request_id"])
            yield {"ok": True}
        elif op == "state":
            yield {
                "router_id": self.router.router_id,
                "tree_blocks": len(self.router.indexer.tree),
                "workers": [w.to_obj() for w in self.router.indexer.tree.workers()],
                "synced_from_peer": self.router.synced_from_peer,
            }
        else:
            yield {"error": f"unknown op {op!r}"}

    async def stop(self) -> None:
        if self.served is not None:
            await self.served.stop()
        if self.router is not None:
            await self.router.stop()
        if self.client is not None:
            await self.client.stop()
