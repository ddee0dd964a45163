"""Worker-side registration: serve an engine + publish its model card.

The port's copy of ``register_llm`` from the reference package's
llm/serve.py: wraps the engine in the Backend operator (detokenize + stop
handling), serves the endpoint on the request plane, and writes the
ModelDeploymentCard into the store under the worker's lease so frontends
discover it; ``serve_clear_endpoint`` serves the ``clear_kv_blocks``
admin endpoint beside it (the frontend's ``POST /clear_kv_blocks`` fans out
to it). The reference's ``eplb_rebalance`` endpoint waits for expert
parallelism with redundant experts (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import os
from typing import Optional

from ..runtime.component import ServedEndpoint
from ..runtime.config import ENV_KV_WIRE
from ..runtime.distributed import DistributedRuntime
from ..runtime.engine import AsyncEngine
from .backend import Backend
from .model_card import ModelDeploymentCard, mdc_key
from .tokenizer import Tokenizer, load_tokenizer


async def register_llm(
    runtime: DistributedRuntime,
    engine: AsyncEngine,
    card: ModelDeploymentCard,
    tokenizer: Optional[Tokenizer] = None,
    raw_token_stream: bool = False,
    instance_id: Optional[int] = None,
) -> ServedEndpoint:
    """Serve ``engine`` behind the Backend for ``card`` and announce it.
    ``raw_token_stream`` serves the engine's stream as it is (an engine
    that already emits finished outputs, or a tensor model's)."""
    handler = engine.generate if raw_token_stream else Backend(
        engine, tokenizer or load_tokenizer(card.tokenizer)).generate
    endpoint = (
        runtime.namespace(card.namespace).component(card.component).endpoint(card.endpoint)
    )
    md = {
        "model": card.name,
        "data_parallel_size": card.runtime_config.data_parallel_size,
        "total_kv_blocks": card.runtime_config.total_kv_blocks,
    }
    # disaggregation: a worker serving KV transfer advertises its fetch
    # address (a streamed hop dispatches the decode request before the
    # prefill ends, so the frontend needs it when it routes) and a wire
    # class for transfer-cost-aware routing; the card carries the bytes of
    # one KV block
    transfer_address = getattr(engine, "transfer_address", None)
    if transfer_address:
        md["transfer_address"] = transfer_address
        md["kv_wire"] = os.environ.get(ENV_KV_WIRE, "inline")
    bpb = int(getattr(engine, "kv_bytes_per_block", 0) or 0)
    if bpb and not card.runtime_config.kv_bytes_per_block:
        card.runtime_config.kv_bytes_per_block = bpb
    served = await endpoint.serve(handler, instance_id=instance_id, metadata=md)
    key = mdc_key(card.namespace, card.slug, served.instance_id)
    await served.publish_extra(key, card.to_obj())
    return served


async def serve_clear_endpoint(
    runtime: DistributedRuntime,
    namespace: str,
    component: str,
    engines,
    instance_id: int,
) -> ServedEndpoint:
    """Serve a ``clear_kv_blocks`` admin endpoint beside generate, under the
    same instance id, so that the frontend's per-worker fan-out targets line
    up. ``engines`` are the engines whose caches this worker owns; integer
    tier counts sum across them."""

    async def handle_clear_kv(request, context):
        levels = (request or {}).get("levels")
        results = []
        for e in engines:
            results.append(await e.clear_kv_blocks(levels))
        out = {k: v for k, v in results[0].items() if isinstance(v, int)}
        for r in results[1:]:
            for k, v in r.items():
                if isinstance(v, int):
                    out[k] = out.get(k, 0) + v
        out["snapshot"] = results[0].get("snapshot")
        yield out

    return await (
        runtime.namespace(namespace).component(component)
        .endpoint("clear_kv_blocks")
        .serve(handle_clear_kv, instance_id=instance_id)
    )
