"""Frontend model discovery: ModelManager + ModelWatcher + routed pipelines.

The port's copy of the reference package's llm/discovery.py. Workers
publish ModelDeploymentCards under ``v1/mdc/...`` tied to their lease; the
frontend watches that prefix and (un)registers one pipeline per model:

    OpenAIPreprocessor -> Migration -> endpoint Client -> worker

with the client's round-robin or random choice of instance. The
reference's KV router, prefill router, global KV directory and per-worker
circuit breakers wait for ROADMAP items 4b and 5.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional

from ..runtime import codec
from ..runtime.component import Client, RouterMode
from ..runtime.discovery.store import EventType
from ..runtime.distributed import DistributedRuntime
from ..runtime.engine import Context
from ..runtime.logging import get_logger
from ..runtime.request_plane.tcp import NoResponders
from ..runtime.tasks import spawn_bg
from .migration import Migration
from .model_card import MDC_PREFIX, MODEL_TYPE_PREFILL, ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor
from .protocols.common import BackendOutput, PreprocessedRequest

log = get_logger("llm.discovery")


class ModelPipeline:
    """Everything needed to serve one model from the frontend."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        card: ModelDeploymentCard,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    ):
        if router_mode not in (RouterMode.ROUND_ROBIN, RouterMode.RANDOM):
            raise ValueError(f"router mode {router_mode.value!r}: the port routes "
                             "round-robin or random (the KV router is ROADMAP item 4b)")
        self.runtime = runtime
        self.card = card
        self.router_mode = router_mode
        self.preprocessor = OpenAIPreprocessor(card)
        self.client: Optional[Client] = None
        self.migration = Migration(self._send, card.migration_limit)
        self._rr = 0  # round-robin over the survivors when some are excluded

    async def start(self) -> "ModelPipeline":
        endpoint = (
            self.runtime.namespace(self.card.namespace)
            .component(self.card.component)
            .endpoint(self.card.endpoint)
        )
        self.client = await endpoint.client(self.router_mode)
        return self

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.stop()

    async def _send(
        self, req: PreprocessedRequest, context: Context, excluded: List[int]
    ) -> AsyncIterator[Any]:
        assert self.client is not None
        instance_id: Optional[int] = None
        if excluded:
            # migration: steer away from the failed instances, round-robin
            # over the survivors
            alive = [i for i in self.client.instance_ids() if i not in excluded]
            if not alive:
                raise NoResponders(f"no non-excluded instances for {self.card.name}")
            instance_id = alive[self._rr % len(alive)]
            self._rr += 1
        try:
            return await self.client.generate(req.to_obj(), context, instance_id)
        except (NoResponders, ConnectionError) as e:
            if instance_id is not None and getattr(e, "instance_id", None) is None:
                e.instance_id = instance_id  # type: ignore[attr-defined]
            raise

    async def generate_tokens(
        self, req: PreprocessedRequest, context: Context
    ) -> AsyncIterator[BackendOutput]:
        """The full internal stream: migration-wrapped routed generation;
        the request's annotations ride on the first output."""
        first = req.annotations.get("op") != "embed"
        async for out in self.migration.generate(req, context):
            if first:
                first = False
                merged = dict(req.annotations)
                merged.update(out.annotations)
                out.annotations = merged
            yield out


class ModelManager:
    def __init__(self):
        self._models: Dict[str, ModelPipeline] = {}

    def get(self, model: str) -> Optional[ModelPipeline]:
        return self._models.get(model)

    def add(self, model: str, pipeline: ModelPipeline) -> None:
        self._models[model] = pipeline

    async def remove(self, model: str) -> None:
        p = self._models.pop(model, None)
        if p is not None:
            await p.stop()

    def list_models(self) -> List[str]:
        return sorted(self._models)


class ModelWatcher:
    """Adds a model's pipeline when its first card appears and removes it
    when its last card goes (a worker's graceful stop deletes its card; a
    killed worker's card goes with its lease's TTL)."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    ):
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self._task: Optional[asyncio.Task] = None
        self._watcher = None
        # mdc store key -> model name (for DELETE handling)
        self._key_model: Dict[str, str] = {}
        self._model_keys: Dict[str, set] = {}

    async def start(self) -> "ModelWatcher":
        self._watcher = await self.runtime.store.watch(MDC_PREFIX + "/")
        # spawn_bg: a dead model watcher means new models never register
        # and removed ones keep serving — log the failure, don't drop it
        self._task = spawn_bg(self._loop())
        return self

    async def _loop(self) -> None:
        assert self._watcher is not None
        async for ev in self._watcher:
            try:
                if ev.type == EventType.PUT and ev.value is not None:
                    await self._handle_put(ev.key, ev.value)
                elif ev.type == EventType.DELETE:
                    await self._handle_delete(ev.key)
            except Exception:
                log.exception("model watcher event failed (%s)", ev.key)

    async def _handle_put(self, key: str, value: bytes) -> None:
        card = ModelDeploymentCard.from_obj(codec.unpackb(value))
        if MODEL_TYPE_PREFILL in card.model_type:
            log.warning("prefill pool card for %s ignored: disaggregation is ROADMAP "
                        "item 5", card.name)
            return
        self._key_model[key] = card.name
        self._model_keys.setdefault(card.name, set()).add(key)
        if self.manager.get(card.name) is None:
            log.info("model %s appeared (card at %s)", card.name, key)
            pipeline = await ModelPipeline(self.runtime, card, self.router_mode).start()
            self.manager.add(card.name, pipeline)

    async def _handle_delete(self, key: str) -> None:
        model = self._key_model.pop(key, None)
        if model is None:
            return
        keys = self._model_keys.get(model, set())
        keys.discard(key)
        if not keys:
            log.info("last instance of model %s gone; deregistering", model)
            self._model_keys.pop(model, None)
            await self.manager.remove(model)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
        if self._watcher is not None:
            self._watcher.cancel()
        for model in list(self.manager.list_models()):
            await self.manager.remove(model)
