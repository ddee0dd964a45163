"""PrefillRouter: disaggregated prefill/decode orchestration on the
frontend, and the global KV directory's fetch planner.

The port's copy of the reference package's llm/prefill_router.py. When a
prefill pool is registered for a model, each request is first
sent to a prefill worker as a clone with ``max_tokens=1``; the decode
request carries the prefill worker's KV-transfer plan (its transfer
address and the prompt's block hashes). With no prefill pool the request
takes the aggregated path (pools scale to zero).

``DisaggConfig`` layers three behaviours on top, as the reference's:

- **transfer-cost-aware selection:** every prefill candidate's logit
  carries the estimated seconds to ship the request's KV over that
  candidate's advertised wire class (the per-wire EWMA of
  runtime/bandwidth.py, fed by real pulls), in the scheduler's block
  units;
- **prefill deflection:** short prompts, prompts whose prefix the DECODE
  pool already holds, and requests whose best disaggregated plan costs
  more than ``1 + deflect_margin`` times a local prefill skip the hop and
  prefill on the decode worker;
- **streamed dispatch:** when the chosen prefill worker advertises its
  transfer address, the decode request ships at once with a streamed
  ``kv_transfer`` handshake, so its block-window pull overlaps the
  prefill's compute.

``GlobalKvFetchPlanner`` (fleet-wide KV reuse, kvbm/directory.py) prices a
fetch of a request's missing prefix from a peer's G2/G3 tier against its
recompute and returns a ``tier`` plan when the fetch wins.

The recompute prior (``DTPU_PREFILL_BLOCK_MS``) defaults to the port's own
measurement on the card, 0.9 ms a block, not to the reference's 10 ms
(``PREFILL_BLOCK_MS`` below; ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..kv_router import KvRouter, KvRouterConfig, WorkerWithDpRank
from ..runtime import metrics as M
from ..runtime.bandwidth import get_bandwidth_estimator
from ..runtime.component import Client, RouterMode
from ..runtime.config import (
    ENV_DEFLECT,
    ENV_DEFLECT_MARGIN,
    ENV_DEFLECT_MAX_TOKENS,
    ENV_DEFLECT_OVERLAP,
    ENV_KV_BYTES_PER_BLOCK,
    ENV_PREFILL_BLOCK_MS,
    ENV_STREAM_KV,
)
from ..runtime.engine import Context
from ..runtime.errors import is_terminal
from ..runtime.flight_recorder import get_flight_recorder
from ..runtime.logging import get_logger
from ..runtime.request_plane.tcp import NoResponders
from ..runtime.tasks import spawn_bg
from ..runtime.tracing import get_tracer
from ..tokens import compute_sequence_hashes
from .model_card import _IMAGE_TOKEN_ID, ModelDeploymentCard
from .preprocessor import ANNOTATION_PREFILL_WORKER_ID
from .protocols.common import BackendOutput, PreprocessedRequest

log = get_logger("llm.prefill_router")

# the KV footprint of a block when neither the config nor the card
# advertises one: the estimate only has to rank wires
_DEFAULT_KV_BYTES_PER_BLOCK = 256 * 1024
# milliseconds to prefill one 16-token KV block, the default of
# DTPU_PREFILL_BLOCK_MS: llama3-8b at 32 layers, bf16, 2048-token chunks,
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase global_kv: the
# slope of a cold worker's TTFT over its prompts' blocks). The reference's
# 10 ms would price a peer-tier fetch of the same blocks, several times
# slower on that card, as the cheaper path.
PREFILL_BLOCK_MS = 0.9


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class DisaggConfig:
    """Knobs of streamed disaggregation, transfer-cost-aware routing and
    prefill deflection (the reference's, with its environment names)."""

    # streamed decode dispatch (DTPU_STREAM_KV=0: the sequential prefill ->
    # transfer -> decode pipeline)
    streamed: bool = True
    # deflection master switch (DTPU_DEFLECT=0: every request pays the hop)
    deflect: bool = True
    # prompts at or under this many tokens never take the hop
    deflect_max_tokens: int = 128
    # deflect when the decode pool already holds this share of the blocks
    deflect_overlap_frac: float = 0.5
    # deflect when the best plan's cost (queue + prefill + wire, in block
    # units) exceeds (1 + margin) x the local prefill's
    deflect_margin: float = 1.0
    # seconds to prefill one KV block: turns wire seconds into block units
    prefill_block_time_s: float = PREFILL_BLOCK_MS / 1e3
    # the per-block wire bytes (0: the card's advertised value)
    kv_bytes_per_block: int = 0

    @classmethod
    def from_env(cls) -> "DisaggConfig":
        return cls(
            streamed=os.environ.get(ENV_STREAM_KV, "1") != "0",
            deflect=os.environ.get(ENV_DEFLECT, "1") != "0",
            deflect_max_tokens=int(_env_f(ENV_DEFLECT_MAX_TOKENS, cls.deflect_max_tokens)),
            deflect_overlap_frac=_env_f(ENV_DEFLECT_OVERLAP, cls.deflect_overlap_frac),
            deflect_margin=_env_f(ENV_DEFLECT_MARGIN, cls.deflect_margin),
            prefill_block_time_s=_env_f(ENV_PREFILL_BLOCK_MS, PREFILL_BLOCK_MS) / 1e3,
            kv_bytes_per_block=int(_env_f(ENV_KV_BYTES_PER_BLOCK, 0)),
        )


@dataclasses.dataclass
class PrefillPlan:
    """One routing decision for the hop, or the decision to skip it:
    ``deflect_reason`` set means aggregated. Otherwise ``worker_id`` names
    the prefill worker, and a ``transfer_address`` with ``streamed`` means
    an early decode dispatch with a streamed ``kv_transfer`` handshake."""

    deflect_reason: Optional[str] = None
    worker_id: Optional[int] = None
    dp_rank: int = 0
    overlap_blocks: int = 0
    query_blocks: int = 0
    transfer_address: Optional[str] = None
    wire: str = "inline"
    streamed: bool = False
    est_transfer_s: float = 0.0
    hashes: List[int] = dataclasses.field(default_factory=list)

    @property
    def deflected(self) -> bool:
        return self.deflect_reason is not None


class GlobalKvFetchPlanner:
    """Fleet-wide KV reuse planning on the frontend (kvbm/directory.py).

    On a local radix miss the missing prefix may be sealed in ANOTHER
    worker's G2/G3 tier. The planner looks the miss up in the global
    directory, prices a fetch from the holder's tier against the recompute
    (``ops/costs.fetch_vs_recompute``, fed by the wire-bandwidth EWMA of
    the ``tier`` class and the holder tier's read prior) and, when the
    fetch wins, returns a ``kv_transfer`` plan (``tier: true``) that
    streams the blocks from the holder over the block-window protocol. A
    stale entry, a dead holder or a lost stream end in a recompute on the
    worker: the plan is advisory, never load-bearing for correctness."""

    # the wire class the tier pull observes into the bandwidth EWMA
    # (engine/transfer.py _pull_tier); unseen, it prices at the inline prior
    WIRE = "tier"

    def __init__(self, directory, *, block_size: int, kv_bytes_per_block: int = 0,
                 prefill_block_time_s: float = PREFILL_BLOCK_MS / 1e3,
                 prefill_base_s: float = 0.0, margin: Optional[float] = None,
                 min_run_blocks: int = 1, bandwidth=None):
        from ..kvbm.directory import fetch_margin

        self.directory = directory
        self.block_size = int(block_size)
        self.kv_bytes_per_block = int(kv_bytes_per_block or _DEFAULT_KV_BYTES_PER_BLOCK)
        self.prefill_block_time_s = float(prefill_block_time_s)
        self.prefill_base_s = float(prefill_base_s)
        self.margin = float(margin if margin is not None else fetch_margin())
        self.min_run_blocks = max(1, int(min_run_blocks))
        self.bandwidth = bandwidth or get_bandwidth_estimator()

    def price(self, num_blocks: int, tier: str = "g2") -> Dict:
        """The fetch-vs-recompute verdict for ``num_blocks`` missing blocks."""
        from ..ops.costs import fetch_vs_recompute

        return fetch_vs_recompute(
            num_blocks, block_size=self.block_size,
            kv_bytes_per_block=self.kv_bytes_per_block,
            bandwidth_bytes_s=self.bandwidth.bandwidth(self.WIRE),
            prefill_base_s=self.prefill_base_s,
            prefill_per_token_s=self.prefill_block_time_s / self.block_size,
            tier=tier, margin=self.margin)

    async def plan_fetch(self, req: PreprocessedRequest, hashes: List[int],
                         overlap_blocks: int,
                         exclude_holder: Optional[str] = None) -> Optional[Dict]:
        """A ``kv_transfer`` plan for the request's missing prefix, or None
        to recompute. ``overlap_blocks`` is the decode pool's best local
        radix overlap (those blocks never fetch); ``hashes`` are at this
        planner's block size. The verdict goes on the request's timeline
        as a ``global_kv_plan`` flight event."""
        miss = [int(h) for h in hashes[overlap_blocks:]]
        if len(miss) < self.min_run_blocks:
            return None
        run = await self.directory.lookup_run(miss, exclude_holder=exclude_holder)
        if len(run) < self.min_run_blocks:
            return None   # nobody (live) holds the prefix: a plain recompute
        head = run[0]
        verdict = self.price(len(run), tier=head.tier)
        get_flight_recorder().record(
            req.request_id, "global_kv_plan", holder=head.holder, tier=head.tier,
            blocks=len(run), fetch_s=round(verdict["fetch_s"], 6),
            recompute_s=round(verdict["recompute_s"], 6), fetch_wins=verdict["fetch_wins"])
        if not verdict["fetch_wins"] or not head.address:
            # the directory had the prefix but the recompute prices cheaper
            # (or the holder advertises no fetch endpoint)
            self.directory.record_outcome("recomputed")
            return None
        return {"address": head.address, "hashes": [e.hash for e in run],
                "num_tokens": len(run) * self.block_size, "tier": True,
                "holder": head.holder, "est_fetch_s": verdict["fetch_s"]}


class PrefillRouter:
    def __init__(self, runtime, card: ModelDeploymentCard,
                 kv_router_config: Optional[KvRouterConfig] = None,
                 disagg: Optional[DisaggConfig] = None):
        self.runtime = runtime
        self.card = card   # the prefill pool's card
        self.client: Optional[Client] = None
        self.kv_router: Optional[KvRouter] = None
        self.kv_router_config = kv_router_config
        self.disagg = disagg or DisaggConfig.from_env()
        self.bandwidth = get_bandwidth_estimator()
        metrics = getattr(runtime, "metrics", None)
        self._deflected = (
            metrics.counter(M.PREFILL_DEFLECTED_TOTAL,
                            "requests that skipped the disagg prefill hop",
                            extra_labels=("reason",))
            if metrics is not None else None)
        if metrics is not None:
            # the frontend's /metrics shows the EWMA its candidates are
            # priced with (workers attach theirs in engine/__main__)
            self.bandwidth.attach_metrics(metrics)

    async def start(self) -> "PrefillRouter":
        endpoint = (self.runtime.namespace(self.card.namespace)
                    .component(self.card.component).endpoint(self.card.endpoint))
        self.client = await endpoint.client(RouterMode.ROUND_ROBIN)
        if self.kv_router_config is not None:
            self.kv_router = await KvRouter(
                self.runtime.event_plane, self.card.namespace, self.card.component,
                block_size=self.card.kv_block_size, config=self.kv_router_config,
                metrics=getattr(self.runtime, "metrics", None),
            ).start()
        return self

    @property
    def has_workers(self) -> bool:
        return self.client is not None and bool(self.client.instances)

    # -- transfer-cost-aware planning and deflection ------------------------
    def _kv_bytes_per_block(self) -> int:
        if self.disagg.kv_bytes_per_block > 0:
            return self.disagg.kv_bytes_per_block
        adv = int(getattr(self.card.runtime_config, "kv_bytes_per_block", 0) or 0)
        return adv or _DEFAULT_KV_BYTES_PER_BLOCK

    def _candidates(self) -> List[WorkerWithDpRank]:
        cands: List[WorkerWithDpRank] = []
        if self.client is None:
            return cands
        # every (instance, dp_rank) is a candidate, as on the decode path
        for iid, inst in self.client.instances.items():
            dp = int(inst.metadata.get("data_parallel_size", 1) or 1)
            for r in range(dp):
                cands.append(WorkerWithDpRank(iid, r))
        return cands

    def _instance_meta(self, iid: int, key: str):
        inst = self.client.instances.get(iid) if self.client else None
        return inst.metadata.get(key) if inst is not None else None

    def _record_deflect(self, req: PreprocessedRequest, reason: str) -> PrefillPlan:
        get_flight_recorder().record(req.request_id, "prefill_deflected", reason=reason)
        if self._deflected is not None:
            self._deflected.inc(reason=reason)
        log.debug("deflecting %s (%s)", req.request_id[:8], reason)
        return PrefillPlan(deflect_reason=reason)

    def plan(self, req: PreprocessedRequest, decode_overlap_blocks: int = 0,
             hashes: Optional[List[int]] = None) -> Optional[PrefillPlan]:
        """Price the hop for this request: deflect it, or pick the prefill
        worker whose queue + remaining prefill + wire cost is lowest.
        ``decode_overlap_blocks``: the prompt blocks the decode pool's
        radix tree already holds (those never ship); ``hashes`` shares a
        caller's hash pass (at this card's block size). None when the pool
        has no candidate (the caller takes the aggregated path).

        Scoring has no side effect (``score_tokens``); the router's
        bookkeeping is committed only when the request takes the hop."""
        cfg = self.disagg
        cands = self._candidates()
        if not cands:
            return None
        tokens = list(req.token_ids)
        block_size = self.card.kv_block_size
        # image placeholder runs hash alike across different images: their
        # blocks are never served from a cache, so neither the overlap nor
        # a streamed handshake may trust the hashes
        cacheable = _IMAGE_TOKEN_ID not in tokens
        if hashes is None:
            hashes = compute_sequence_hashes(tokens, block_size)
        query_blocks = max(len(tokens) // block_size, 0)
        if cfg.deflect:
            if len(tokens) <= cfg.deflect_max_tokens:
                return self._record_deflect(req, "short_prompt")
            if (cacheable and query_blocks > 0
                    and decode_overlap_blocks >= cfg.deflect_overlap_frac * query_blocks):
                return self._record_deflect(req, "radix_hit")
        # each candidate's wire cost in block units: the bytes that ship
        # over its advertised wire class at the EWMA bandwidth
        move_blocks = max(query_blocks - decode_overlap_blocks, 0)
        move_bytes = move_blocks * self._kv_bytes_per_block()
        wires: Dict[WorkerWithDpRank, str] = {}
        extra: Dict[WorkerWithDpRank, float] = {}
        for cand in cands:
            wire = str(self._instance_meta(cand.worker_id, "kv_wire") or "inline")
            wires[cand] = wire
            extra[cand] = (self.bandwidth.transfer_seconds(wire, move_bytes)
                           / cfg.prefill_block_time_s)
        decision = None
        if self.kv_router is not None:
            decision = self.kv_router.score_tokens(
                tokens, cands, extra_costs=extra, hashes=hashes if cacheable else [])
            chosen = decision.worker
            overlap = decision.overlap_blocks
            remote_cost = decision.logits[chosen]
        else:
            # round-robin pools still price the wire: the cheapest wins
            chosen = min(cands, key=lambda c: (extra[c], c))
            overlap = 0
            remote_cost = query_blocks + extra[chosen]
        wire = wires[chosen]
        est_transfer_s = self.bandwidth.transfer_seconds(wire, move_bytes)
        if cfg.deflect:
            # load-aware valve: the hop must beat (1 + margin) x a local prefill
            local_cost = max(query_blocks - decode_overlap_blocks, 1)
            if remote_cost > (1.0 + cfg.deflect_margin) * local_cost:
                return self._record_deflect(req, "load_skew")
        if decision is not None:
            self.kv_router.commit_route(decision, hashes if cacheable else [])
        address = self._instance_meta(chosen.worker_id, "transfer_address")
        # streamed dispatch only targets rank 0: the transfer server serves
        # the first engine's cache
        streamed = bool(cfg.streamed and address and cacheable and chosen.dp_rank == 0)
        return PrefillPlan(
            worker_id=chosen.worker_id, dp_rank=chosen.dp_rank, overlap_blocks=overlap,
            query_blocks=query_blocks, transfer_address=address if streamed else None,
            wire=wire, streamed=streamed, est_transfer_s=est_transfer_s,
            hashes=[int(h) for h in hashes[:query_blocks]] if cacheable else [],
        )

    def _prefill_clone(self, req: PreprocessedRequest) -> PreprocessedRequest:
        preq = PreprocessedRequest.from_obj(req.to_obj())
        preq.stop.max_tokens = 1
        preq.stop.min_tokens = 0
        preq.stop.stop_strings = []
        preq.annotations["disagg"] = "prefill"
        return preq

    def start_streamed_prefill(self, req: PreprocessedRequest, context: Context,
                               plan: PrefillPlan):
        """Fire the ``max_tokens=1`` prefill clone without waiting for it:
        the caller dispatches the decode request at once with a streamed
        ``kv_transfer`` handshake. The clone's token is dropped (the decode
        worker samples the first token from the imported KV); its job is
        the KV blocks. Returns the background task."""
        preq = self._prefill_clone(req)
        preq.annotations["dp_rank"] = plan.dp_rank

        async def drive() -> None:
            get_flight_recorder().record(
                preq.request_id, "prefill_streamed", worker=f"{plan.worker_id:016x}",
                wire=plan.wire, est_transfer_s=round(plan.est_transfer_s, 6))
            try:
                stream = await self.client.generate(preq.to_obj(), context.child(),
                                                    plan.worker_id)
                async for item in stream:
                    out = item if isinstance(item, BackendOutput) else BackendOutput.from_obj(item)
                    if out.finish_reason is not None:
                        break
            except Exception:
                # the decode side recomputes whatever never streams over:
                # the request completes without the overlap
                log.exception("streamed prefill failed for %s; the decode side recomputes",
                              preq.request_id[:8])

        return spawn_bg(drive())

    async def run_prefill(self, req: PreprocessedRequest, context: Context,
                          plan: Optional[PrefillPlan] = None) -> Optional[BackendOutput]:
        """Send the ``max_tokens=1`` clone to a prefill worker. Returns its
        output (the first token and the ``kv_transfer`` plan), or None when
        the pool failed or is gone (the caller takes the aggregated path);
        a typed terminal error (the request itself is wrong) raises.
        ``plan`` pins the transfer-cost-aware choice of worker."""
        assert self.client is not None
        preq = self._prefill_clone(req)
        # the prefill dispatch is a span of its own, and the prefill
        # worker's spans parent on it
        tracer = get_tracer()
        span = None
        if tracer.enabled:
            span = tracer.span("router.prefill",
                               traceparent=preq.annotations.get("traceparent"),
                               request_id=preq.request_id)
            span.__enter__()
            preq.annotations["traceparent"] = span.traceparent()
        instance_id: Optional[int] = None
        try:
            if plan is not None and plan.worker_id is not None:
                instance_id = plan.worker_id
                preq.annotations["dp_rank"] = plan.dp_rank
                if span is not None:
                    span.set(worker=f"{instance_id:016x}", dp_rank=plan.dp_rank,
                             overlap_blocks=plan.overlap_blocks, wire=plan.wire,
                             est_transfer_s=round(plan.est_transfer_s, 6))
            elif self.kv_router is not None and self.client.instances:
                decision = self.kv_router.schedule_tokens(preq.token_ids, self._candidates())
                instance_id = decision.worker.worker_id
                preq.annotations["dp_rank"] = decision.worker.dp_rank
                if span is not None:
                    span.set(worker=f"{instance_id:016x}", dp_rank=decision.worker.dp_rank,
                             overlap_blocks=decision.overlap_blocks)
            get_flight_recorder().record(
                preq.request_id, "prefill_routed",
                worker=f"{instance_id:016x}" if instance_id is not None else "round-robin")
            try:
                stream = await self.client.generate(preq.to_obj(), context.child(), instance_id)
                last: Optional[BackendOutput] = None
                async for item in stream:
                    out = item if isinstance(item, BackendOutput) else BackendOutput.from_obj(item)
                    last = out
                    if out.finish_reason is not None:
                        break
                if last is not None and instance_id is not None:
                    last.annotations[ANNOTATION_PREFILL_WORKER_ID] = instance_id
                return last
            except NoResponders:
                log.info("prefill pool unavailable; taking the aggregated path")
                if span is not None:
                    span.status = "ERROR"
                    span.set(error="no responders")
                return None
            except Exception as e:
                if span is not None:
                    span.status = "ERROR"
                    span.set(error=repr(e))
                if is_terminal(e):
                    # a typed 4xx-class failure: the aggregated path would
                    # only run the same doomed prefill again
                    raise
                log.exception("prefill failed; taking the aggregated path")
                return None
        finally:
            if span is not None:
                span.__exit__(None, None, None)

    async def stop(self) -> None:
        if self.kv_router is not None:
            await self.kv_router.stop()
        if self.client is not None:
            await self.client.stop()
