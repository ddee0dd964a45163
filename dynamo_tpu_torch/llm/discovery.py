"""Frontend model discovery: ModelManager + ModelWatcher + routed pipelines.

The port's copy of the reference package's llm/discovery.py. Workers
publish ModelDeploymentCards under ``v1/mdc/...`` tied to their lease; the
frontend watches that prefix and (un)registers one pipeline per model:

    OpenAIPreprocessor -> Migration -> [KvRouter] -> endpoint Client -> worker

with the client's round-robin or random choice of instance, or in KV mode
the KV router's (kv_router/): the worker whose cached prefix and load cost
least. With tracing on, each routing decision is a ``router.schedule``
span whose id replaces the request's ``traceparent`` annotation, and each
lands on the request's flight-recorder timeline (``routed``).

Each worker has a circuit breaker (runtime/resilience.py, scope
``DTPU_CB_WORKER``) fed by its outcomes: a send that fails and a stream
that ends without a finish, with an error finish or on a lost connection
count against it, a clean finish for it. Routing steers new requests and
migration retries around open circuits, round-robin and KV alike, unless
that would leave no worker at all.

Disaggregation: the watcher also tracks each model's prefill pool (cards
of ``model_type`` ``prefill``) and attaches a ``PrefillRouter``
(llm/prefill_router.py) to the model's pipeline while the pool has a
member, detaching it when the last one goes. A request then takes the
hop: deflected (the decode worker prefills it), streamed (the prefill
clone fires and the decode request ships at once with a streamed
``kv_transfer`` handshake) or sequential (the prefill's first token
streams, then the decode request pulls the finished prefill's pages).
A typed terminal error of the prefill pool reaches the client; any other
prefill failure takes the aggregated path.

Planned reclaims (engine/drain.py): a worker whose discovery record says
``state=draining`` gets no new work and no migration retry, unless every
worker is draining (a draining worker still serves until its deadline).
A migration that carries an evacuation plan is routed, in KV mode, by the
cost of pulling the plan's blocks over each candidate's advertised wire
(``_evacuation_costs``: the bandwidth EWMA of runtime/bandwidth.py, in
units of the recompute prior ``DTPU_PREFILL_BLOCK_MS``).

Fleet-wide KV reuse (``DTPU_GLOBAL_KV=1``): each pipeline keeps a
lookup-only client of the global KV directory (kvbm/directory.py; the
frontend never publishes) and a ``GlobalKvFetchPlanner``. A request on the
aggregated or deflected path whose missing prefix another worker's G2/G3
holds, and whose fetch prices cheaper than its recompute, carries a
``tier`` ``kv_transfer`` plan to its worker. A failure in planning means
no plan.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional

from ..kv_router import KvRouter, KvRouterConfig, WorkerWithDpRank
from ..runtime import codec
from ..runtime import metrics as M
from ..runtime.component import Client, RouterMode
from ..runtime.discovery.store import EventType
from ..runtime.distributed import DistributedRuntime
from ..runtime.engine import Context
from ..runtime.flight_recorder import get_flight_recorder
from ..runtime.logging import get_logger
from ..runtime.request_plane.tcp import NoResponders
from ..runtime.resilience import OPEN, CircuitBreaker
from ..runtime.tasks import spawn_bg
from ..runtime.tracing import get_tracer
from .migration import Migration
from .model_card import MDC_PREFIX, MODEL_TYPE_PREFILL, ModelDeploymentCard
from ..tokens import compute_sequence_hashes
from .preprocessor import (
    ANNOTATION_CACHED_TOKENS,
    ANNOTATION_PREFILL_WORKER_ID,
    ANNOTATION_WORKER_ID,
    OpenAIPreprocessor,
)
from .protocols.common import BackendOutput, PreprocessedRequest

log = get_logger("llm.discovery")


class _RecordedStream:
    """Wraps a worker response stream and reports the worker's outcome to
    its circuit breaker: clean finish -> success; transport loss, an
    ``error`` finish frame, or EOF-without-finish (the signals Migration
    treats as worker death) -> failure. Preserves ``instance_id`` so the
    migration operator can still attribute failures."""

    def __init__(self, stream, record):
        self._stream = stream
        self._record = record
        self._done = False
        self.instance_id = getattr(stream, "instance_id", None)

    def _close(self, ok: bool) -> None:
        if not self._done:
            self._done = True
            self._record(ok)

    def __aiter__(self) -> "_RecordedStream":
        return self

    async def __anext__(self):
        try:
            item = await self._stream.__anext__()
        except StopAsyncIteration:
            # EOF without a finish frame = worker died mid-request
            self._close(False)
            raise
        except (NoResponders, ConnectionError):
            self._close(False)
            raise
        fr = (item.get("finish_reason") if isinstance(item, dict)
              else getattr(item, "finish_reason", None))
        if fr is not None:
            # record AT the finish frame: consumers (Migration) return from
            # their async-for right here, so the iterator is never exhausted
            # on the success path
            self._close(fr != "error")
        return item


class ModelPipeline:
    """Everything needed to serve one model from the frontend."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        card: ModelDeploymentCard,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_config: Optional[KvRouterConfig] = None,
    ):
        if router_mode == RouterMode.DIRECT:
            raise ValueError("router mode 'direct': the frontend routes round-robin, "
                             "random or kv")
        self.runtime = runtime
        self.card = card
        self.router_mode = router_mode
        self.kv_router_config = kv_router_config
        self.preprocessor = OpenAIPreprocessor(card)
        self.client: Optional[Client] = None
        self.kv_router: Optional[KvRouter] = None
        self.migration = Migration(self._send, card.migration_limit)
        self._known_worker_ids: set = set()
        # per-worker circuit breakers (scope DTPU_CB_WORKER): a flapping
        # worker that keeps dropping streams trips its circuit and routing
        # steers around it (retry-then-migrate) until the reset probe
        # passes. Their metrics go to a detached scope, not the runtime's
        # registry: worker ids are ephemeral, and one series per id ever
        # seen would grow /metrics without bound under churn (the per-model
        # frontend breaker stays on /metrics)
        self._worker_breakers: Dict[int, CircuitBreaker] = {}
        # disaggregation: set while a prefill pool is registered for the model
        self.prefill_router = None
        # fleet-wide KV reuse: the directory's fetch planner (DTPU_GLOBAL_KV)
        self.global_kv = None
        self._worker_cb_metrics = M.MetricsScope()
        # router-universe reconcile throttle (_prune_dead_workers): the
        # full sweep is O(fleet), so it runs on instance-count change or
        # every N requests, not per decision
        self._router_sync_tick = 0
        self._router_synced_count = -1
        self._rr = 0  # round-robin over the survivors when some are shunned

    def _worker_cb(self, iid: int) -> CircuitBreaker:
        cb = self._worker_breakers.get(iid)
        if cb is None:
            cb = self._worker_breakers[iid] = CircuitBreaker.from_env(
                "worker", name=f"worker.{iid:016x}",
                failure_threshold=3, failure_rate=0.5, window_s=10.0,
                reset_timeout_s=2.0, metrics=self._worker_cb_metrics,
            )
        return cb

    def _tripped(self, excluded: List[int]) -> List[int]:
        """Workers to steer around: open circuits, unless that would leave
        no candidate at all (then trying a tripped worker beats failing).
        Only workers that ever recorded an outcome have a breaker, so the
        scan is O(breakers), never O(fleet): a worker with no breaker is
        treated as closed without constructing one."""
        assert self.client is not None
        inst = self.client.instances
        # drop breakers of departed workers when the table outgrows the
        # fleet (the KV path also sweeps them in _prune_dead_workers)
        if len(self._worker_breakers) > len(inst):
            for iid in list(self._worker_breakers):
                if iid not in inst:
                    self._worker_breakers.pop(iid, None)
        return self._unless_none_left(excluded, [
            iid for iid, cb in self._worker_breakers.items()
            if iid not in excluded and iid in inst and cb.state == OPEN])

    def _unless_none_left(self, excluded: List[int], avoid: List[int]) -> List[int]:
        """``avoid``, unless avoiding it beside ``excluded`` would leave no
        live instance (counts over live instances)."""
        inst = self.client.instances
        shun_live = sum(1 for iid in set(excluded) if iid in inst)
        if not avoid or len(inst) - shun_live - len(avoid) <= 0:
            return []
        return avoid

    def _draining(self, excluded: List[int]) -> List[int]:
        """Workers whose discovery record advertises a planned reclaim
        (``state=draining``): new work and migration retries steer around
        them (a retry that lands on a worker seconds from death migrates
        twice), unless that would leave no candidate: a draining worker
        beats none, as it serves until its deadline."""
        assert self.client is not None
        return self._unless_none_left(excluded, [
            iid for iid, rec in self.client.instances.items()
            if iid not in excluded and rec.metadata.get("state") == "draining"])

    def _evacuation_costs(self, req: PreprocessedRequest, inst_map,
                          shun: List[int]) -> Optional[Dict[WorkerWithDpRank, float]]:
        """Destination costs of an evacuation replay: a request that carries
        a plan's blocks in ``kv_transfer`` charges every candidate the time
        to pull them over its advertised wire class (``kv_wire``; the
        per-wire bandwidth EWMA), in block units of the recompute prior (the
        KV scheduler's ``extra_costs`` currency). None for other requests:
        the common path pays nothing."""
        hashes = (req.kv_transfer or {}).get("hashes") or ()
        if not hashes:
            return None
        from ..runtime.bandwidth import get_bandwidth_estimator
        from ..runtime.config import ENV_PREFILL_BLOCK_MS, env_float
        from .prefill_router import PREFILL_BLOCK_MS

        bw = get_bandwidth_estimator()
        bpb = int(req.kv_transfer.get("bytes_per_block", 0) or 0) or (
            int(getattr(self.card.runtime_config, "kv_bytes_per_block", 0) or 0)
            or 256 * 1024)
        move_bytes = len(hashes) * bpb
        block_time_s = env_float(ENV_PREFILL_BLOCK_MS, PREFILL_BLOCK_MS) / 1e3
        shun_set = set(shun)
        costs: Dict[WorkerWithDpRank, float] = {}
        for iid, inst in inst_map.items():
            if iid in shun_set:
                continue
            wire = str(inst.metadata.get("kv_wire") or "inline")
            cost = bw.transfer_seconds(wire, move_bytes) / block_time_s
            for r in range(int(inst.metadata.get("data_parallel_size", 1) or 1)):
                costs[WorkerWithDpRank(iid, r)] = cost
        return costs or None

    async def start(self) -> "ModelPipeline":
        endpoint = (
            self.runtime.namespace(self.card.namespace)
            .component(self.card.component)
            .endpoint(self.card.endpoint)
        )
        self.client = await endpoint.client(
            RouterMode.ROUND_ROBIN if self.router_mode == RouterMode.KV else self.router_mode
        )
        if self.router_mode == RouterMode.KV:
            self.kv_router = await KvRouter(
                self.runtime.event_plane,
                self.card.namespace,
                self.card.component,
                block_size=self.card.kv_block_size,
                config=self.kv_router_config,
                metrics=self.runtime.metrics,
            ).start()
        from ..kvbm.directory import GlobalKvDirectory, directory_enabled

        if directory_enabled():
            # a lookup-only client: the frontend resolves misses and never
            # publishes (no lease)
            from .prefill_router import DisaggConfig, GlobalKvFetchPlanner

            directory = GlobalKvDirectory(self.runtime.store, f"frontend/{self.card.name}",
                                          metrics=self.runtime.metrics)
            self.global_kv = GlobalKvFetchPlanner(
                directory, block_size=self.card.kv_block_size,
                kv_bytes_per_block=int(self.card.runtime_config.kv_bytes_per_block or 0),
                prefill_block_time_s=DisaggConfig.from_env().prefill_block_time_s)
        return self

    async def stop(self) -> None:
        if self.prefill_router is not None:
            await self.prefill_router.stop()
        if self.kv_router is not None:
            await self.kv_router.stop()
        if self.client is not None:
            await self.client.stop()

    def _prune_dead_workers(self) -> None:
        """Sync the KV router's candidate universe with discovery: departed
        instances are removed, new ones registered (per dp_rank). Routing
        then passes only per-request exclusion sets — the O(K) path — and
        never builds a fleet-sized candidate list per decision.

        The reconcile itself is O(fleet), so it is throttled: it runs when
        the instance count changes and on a coarse request tick, not per
        decision. The sweep walks the router's *registered universe*, not a
        known-set delta — a late metrics event auto-registers workers in
        the scheduler (update_metrics), so a removed worker can be
        resurrected after its one-shot delta removal and must be swept out
        again."""
        if self.kv_router is None or self.client is None:
            return
        inst_map = self.client.instances
        self._router_sync_tick += 1
        if (
            len(inst_map) == self._router_synced_count
            and self._router_sync_tick % 64 != 1
        ):
            return
        live = set(inst_map)
        for w in self.kv_router.scheduler.known_workers():
            if w.worker_id not in live:
                self.kv_router.remove_worker_id(w.worker_id)
                self._worker_breakers.pop(w.worker_id, None)
        for iid in live - self._known_worker_ids:
            inst = inst_map.get(iid)
            dp = int(inst.metadata.get("data_parallel_size", 1) or 1) if inst else 1
            for r in range(dp):
                self.kv_router.register_worker(WorkerWithDpRank(iid, r))
        self._known_worker_ids = live
        self._router_synced_count = len(inst_map)

    def _kv_route(self, req: PreprocessedRequest, excluded: List[int]) -> int:
        """The KV router's worker for ``req`` (``_kv_decide``)."""
        return self._kv_decide(req, excluded).worker.worker_id

    def _kv_decide(self, req: PreprocessedRequest, excluded: List[int]):
        """The KV router's decision for ``req``, excluding ``excluded`` (the
        migration's failed instances and the open circuits); stamps the
        predicted cached tokens, the worker and its dp_rank on the
        request's annotations."""
        assert self.kv_router is not None and self.client is not None
        self._prune_dead_workers()
        inst_map = self.client.instances
        shun_live = sum(1 for iid in set(excluded) if iid in inst_map)
        if not inst_map or shun_live >= len(inst_map):
            # every instance is excluded (dead mid-request): fail this
            # attempt rather than route back onto a dead worker
            raise NoResponders(f"no non-excluded instances for {self.card.name}")
        excl = set()
        for iid in excluded:
            inst = inst_map.get(iid)
            dp = int(inst.metadata.get("data_parallel_size", 1) or 1) if inst is not None else 1
            for r in range(dp):
                excl.add(WorkerWithDpRank(iid, r))
        decision = self.kv_router.schedule_tokens(
            req.token_ids, excluded=excl, request_id=req.request_id,
            lora=req.annotations.get("lora"),
            extra_costs=self._evacuation_costs(req, inst_map, excluded))
        instance_id = decision.worker.worker_id
        req.annotations[ANNOTATION_CACHED_TOKENS] = (
            decision.overlap_blocks * self.card.kv_block_size)
        req.annotations[ANNOTATION_WORKER_ID] = instance_id
        req.annotations["dp_rank"] = decision.worker.dp_rank
        return decision

    async def _send(
        self, req: PreprocessedRequest, context: Context, excluded: List[int]
    ) -> AsyncIterator[Any]:
        assert self.client is not None
        instance_id: Optional[int] = None
        # trace hop: the routing decision gets its own span, and its id
        # REPLACES the traceparent annotation the worker parents on, so one
        # trace reads frontend -> router -> worker in order
        tracer = get_tracer()
        span = None
        if tracer.enabled:
            span = tracer.span("router.schedule",
                               traceparent=req.annotations.get("traceparent"),
                               request_id=req.request_id, model=self.card.name)
            span.__enter__()
            req.annotations["traceparent"] = span.traceparent()
        try:
            # per-request exclusions (migration), cross-request tripped
            # circuits and draining workers, all steered around the same
            # way; _draining sees the combined set, so that its empty-pool
            # fallback counts the workers already shunned
            shun = list(excluded) + self._tripped(excluded)
            shun += self._draining(shun)
            # pooled forwards touch no KV pages: the KV scheduler would
            # charge them phantom blocks that nothing frees
            use_kv = self.kv_router is not None and req.annotations.get("op") != "embed"
            overlap_tokens = 0
            if use_kv:
                decision = self._kv_decide(req, shun)
                instance_id = decision.worker.worker_id
                overlap_tokens = decision.overlap_blocks * self.card.kv_block_size
                if span is not None:
                    span.set(mode="kv", worker=f"{instance_id:016x}",
                             dp_rank=decision.worker.dp_rank,
                             overlap_blocks=decision.overlap_blocks,
                             query_blocks=decision.query_blocks, excluded=len(shun))
            elif shun:
                # steer away from the failed (migration) and tripped
                # instances, round-robin over the survivors: pinning to
                # alive[0] would dump a tripped worker's whole share onto
                # one neighbour for the open window
                alive = [i for i in self.client.instance_ids() if i not in shun]
                if not alive:
                    raise NoResponders(f"no non-excluded instances for {self.card.name}")
                instance_id = alive[self._rr % len(alive)]
                self._rr += 1
            worker = f"{instance_id:016x}" if instance_id is not None else "client-routed"
            if span is not None and not use_kv:
                span.set(mode=str(self.router_mode.value), worker=worker,
                         excluded=len(shun))
            get_flight_recorder().record(req.request_id, "routed", worker=worker,
                                         overlap_tokens=overlap_tokens,
                                         excluded=len(shun))
            try:
                stream = await self.client.generate(req.to_obj(), context, instance_id)
            except (NoResponders, ConnectionError) as e:
                if instance_id is not None and getattr(e, "instance_id", None) is None:
                    e.instance_id = instance_id  # type: ignore[attr-defined]
                iid = getattr(e, "instance_id", None)
                if iid is not None:
                    cb = self._worker_cb(iid)
                    # reserve the half-open probe slot (a no-op when closed)
                    # so that this outcome counts as the probe's; the breaker
                    # ignores unreserved results in half-open as stale
                    cb.allow()
                    cb.record(False)
                raise
        except Exception as e:
            if span is not None:
                span.status = "ERROR"
                span.set(error=repr(e))
            raise
        finally:
            if span is not None:
                span.__exit__(None, None, None)
        iid = getattr(stream, "instance_id", None)
        if iid is None:
            return stream
        cb = self._worker_cb(iid)
        cb.allow()  # as above: this stream IS the half-open probe
        return _RecordedStream(stream, cb.record)

    def _decode_overlap(self, req: PreprocessedRequest, hashes=None) -> int:
        """Prompt blocks the DECODE pool's radix tree already holds (the
        radix-hit deflection signal); 0 when KV routing is off. A
        stateless peek: no load charge, no index update. ``hashes`` shares
        a caller's hash pass (at this router's block size)."""
        if self.kv_router is None or self.client is None or not self.client.instances:
            return 0
        try:
            return self.kv_router.score_tokens(req.token_ids, self._candidates([]),
                                               hashes=hashes).overlap_blocks
        except Exception:
            return 0

    def _candidates(self, excluded: List[int]) -> List[WorkerWithDpRank]:
        assert self.client is not None
        cands: List[WorkerWithDpRank] = []
        for iid, inst in self.client.instances.items():
            if iid in excluded:
                continue
            dp = int(inst.metadata.get("data_parallel_size", 1) or 1)
            cands.extend(WorkerWithDpRank(iid, r) for r in range(dp))
        return cands

    async def generate_tokens(
        self, req: PreprocessedRequest, context: Context
    ) -> AsyncIterator[BackendOutput]:
        """The full internal stream: [the prefill hop ->] migration-wrapped
        routed generation; the request's annotations ride on the first
        output. With no prefill pool (or a prefill failure) the aggregated
        path serves the request unchanged."""
        offset = 0
        if req.annotations.get("op") == "embed":
            # pooled forwards never split across prefill and decode pools
            async for out in self.migration.generate(req, context):
                yield out
            return
        if self.prefill_router is not None and self.prefill_router.has_workers:
            plan = None
            try:
                # ONE hash pass serves the decode-overlap peek, the plan's
                # scoring and the streamed handshake when both pools share
                # a block size (the normal deployment)
                bs_p = self.prefill_router.card.kv_block_size
                shared = (compute_sequence_hashes(req.token_ids, bs_p)
                          if self.kv_router is None or self.kv_router.block_size == bs_p
                          else None)
                plan = self.prefill_router.plan(
                    req, decode_overlap_blocks=self._decode_overlap(req, shared),
                    hashes=shared)
            except Exception:
                log.exception("disagg planning failed; taking the sequential prefill path")
            if plan is not None and plan.deflected:
                # deflected: the aggregated path below prefills on the
                # decode worker
                pre_out = None
            elif plan is not None and plan.streamed:
                # streamed: fire the prefill clone and ship the decode
                # request now, its block-window pull overlapping the prefill
                self.prefill_router.start_streamed_prefill(req, context, plan)
                bs = self.prefill_router.card.kv_block_size
                req = PreprocessedRequest.from_obj(req.to_obj())
                req.kv_transfer = {
                    "address": plan.transfer_address,
                    "hashes": list(plan.hashes),
                    "num_tokens": plan.query_blocks * bs,
                    "stream": True,
                }
                req.annotations[ANNOTATION_PREFILL_WORKER_ID] = plan.worker_id
                pre_out = None
            else:
                pre_out = await self.prefill_router.run_prefill(req, context, plan)
            if pre_out is not None and pre_out.token_ids:
                merged = dict(req.annotations)
                merged.update(pre_out.annotations)
                if req.stop.max_tokens == 1:
                    pre_out.annotations = merged
                    yield pre_out
                    return
                # the first token streams now, with its text and logprob
                # entries (the reference's first output carries the ids
                # alone, so its frontend never shows the first token's
                # text); decode continues from it
                first_tok = pre_out.token_ids[-1]
                yield BackendOutput(token_ids=list(pre_out.token_ids), text=pre_out.text,
                                    cumulative_tokens=1, logprobs=pre_out.logprobs,
                                    top_logprobs=pre_out.top_logprobs,
                                    logprob_entries=pre_out.logprob_entries,
                                    annotations=merged)
                offset = 1
                req = PreprocessedRequest.from_obj(req.to_obj())
                req.prior_token_ids = [first_tok]
                req.kv_transfer = pre_out.kv_transfer
                if req.kv_transfer:
                    # sequential: the prefill is complete, so the one-shot
                    # blocking pull (which may take the device path) beats
                    # the window protocol
                    req.kv_transfer = dict(req.kv_transfer)
                    req.kv_transfer.pop("stream", None)
                if req.stop.max_tokens is not None:
                    req.stop.max_tokens -= 1
        if self.global_kv is not None and not req.kv_transfer:
            # fleet-wide KV reuse: the aggregated or deflected path would
            # recompute its whole miss, unless another worker's G2/G3 holds
            # the sealed blocks and fetching them prices cheaper
            try:
                bs = self.global_kv.block_size
                hashes = compute_sequence_hashes(req.token_ids, bs)
                fetch = await self.global_kv.plan_fetch(
                    req, hashes, overlap_blocks=self._decode_overlap(req, (
                        hashes if self.kv_router is not None
                        and self.kv_router.block_size == bs else None)))
                if fetch is not None:
                    req = PreprocessedRequest.from_obj(req.to_obj())
                    req.kv_transfer = fetch
            except Exception:
                log.warning("global kv fetch planning failed; recomputing locally",
                            exc_info=True)
        first = offset == 0
        try:
            async for out in self.migration.generate(req, context):
                if first:
                    first = False
                    merged = dict(req.annotations)
                    merged.update(out.annotations)
                    out.annotations = merged
                if offset:
                    out.cumulative_tokens += offset
                yield out
        finally:
            if self.kv_router is not None:
                self.kv_router.complete(req.request_id)


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

    def pipelines(self) -> List[ModelPipeline]:
        return list(self._models.values())


class ModelWatcher:
    """Adds a model's pipeline when its first card appears and removes it
    when its last card goes (a worker's graceful stop deletes its card; a
    killed worker's card goes with its lease's TTL)."""

    def __init__(
        self,
        runtime: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_config: Optional[KvRouterConfig] = None,
    ):
        self.runtime = runtime
        self.manager = manager
        self.router_mode = router_mode
        self.kv_router_config = kv_router_config
        self._task: Optional[asyncio.Task] = None
        self._watcher = None
        # mdc store key -> model name (for DELETE handling)
        self._key_model: Dict[str, str] = {}
        self._model_keys: Dict[str, set] = {}
        # disaggregation: prefill pool cards and their keys by model name
        self._prefill_cards: Dict[str, ModelDeploymentCard] = {}
        self._prefill_keys: Dict[str, set] = {}

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
        self._key_model[key] = card.name
        if MODEL_TYPE_PREFILL in card.model_type:
            self._prefill_keys.setdefault(card.name, set()).add(key)
            if card.name not in self._prefill_cards:
                self._prefill_cards[card.name] = card
                log.info("prefill pool for %s appeared", card.name)
            await self._sync_prefill(card.name)
            return
        self._model_keys.setdefault(card.name, set()).add(key)
        if self.manager.get(card.name) is None:
            log.info("model %s appeared (card at %s)", card.name, key)
            pipeline = await ModelPipeline(
                self.runtime, card, self.router_mode, self.kv_router_config
            ).start()
            self.manager.add(card.name, pipeline)
        await self._sync_prefill(card.name)

    async def _sync_prefill(self, model: str) -> None:
        """Attach or detach the model's PrefillRouter as its prefill pool
        comes and goes."""
        pipe = self.manager.get(model)
        if pipe is None:
            return
        has_pool = bool(self._prefill_keys.get(model))
        if has_pool and pipe.prefill_router is None:
            from .prefill_router import PrefillRouter

            pipe.prefill_router = await PrefillRouter(
                self.runtime, self._prefill_cards[model],
                self.kv_router_config if self.router_mode == RouterMode.KV else None,
            ).start()
            log.info("disaggregation enabled for %s", model)
        elif not has_pool and pipe.prefill_router is not None:
            router, pipe.prefill_router = pipe.prefill_router, None
            await router.stop()
            log.info("disaggregation disabled for %s (prefill pool empty)", model)

    async def _handle_delete(self, key: str) -> None:
        model = self._key_model.pop(key, None)
        if model is None:
            return
        pkeys = self._prefill_keys.get(model)
        if pkeys is not None and key in pkeys:
            pkeys.discard(key)
            if not pkeys:
                self._prefill_cards.pop(model, None)
                self._prefill_keys.pop(model, None)
            await self._sync_prefill(model)
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
