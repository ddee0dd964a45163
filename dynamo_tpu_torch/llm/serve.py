"""Worker-side registration: serve an engine + publish its model card.

The port's copy of ``register_llm`` from the reference package's
llm/serve.py: wraps the engine in the Backend operator (detokenize + stop
handling), serves the endpoint on the request plane, and writes the
ModelDeploymentCard into the store under the worker's lease so frontends
discover it. The reference's ``clear_kv_blocks`` and ``eplb_rebalance``
admin endpoints wait for the engine hooks they call (ROADMAP item 4b).
"""

from __future__ import annotations

from typing import Optional

from ..runtime.component import ServedEndpoint
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
    instance_id: Optional[int] = None,
) -> ServedEndpoint:
    """Serve ``engine`` behind the Backend for ``card`` and announce it."""
    handler = Backend(engine, tokenizer or load_tokenizer(card.tokenizer)).generate
    endpoint = (
        runtime.namespace(card.namespace).component(card.component).endpoint(card.endpoint)
    )
    md = {
        "model": card.name,
        "data_parallel_size": card.runtime_config.data_parallel_size,
        "total_kv_blocks": card.runtime_config.total_kv_blocks,
    }
    served = await endpoint.serve(handler, instance_id=instance_id, metadata=md)
    key = mdc_key(card.namespace, card.slug, served.instance_id)
    await served.publish_extra(key, card.to_obj())
    return served
