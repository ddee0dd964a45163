"""Built-in toy engines: echo (tokens in -> tokens out) for tests and wiring.

The port's copy of the reference package's llm/engines.py."""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator

from ..runtime.engine import Context
from .protocols.common import FINISH_LENGTH, FINISH_STOP, BackendOutput, PreprocessedRequest


class EchoEngine:
    """Streams the prompt's token ids back one at a time (bounded by
    max_tokens), with a configurable per-token delay to exercise streaming."""

    def __init__(self, delay_s: float = 0.0):
        self.delay_s = delay_s

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[BackendOutput]:
        req = request if isinstance(request, PreprocessedRequest) else PreprocessedRequest.from_obj(request)
        if req.annotations.get("op") == "embed":
            # deterministic toy embedding so the API surface is testable
            vec = [float(len(req.token_ids))] + [float(t) for t in req.token_ids[:3]]
            yield BackendOutput(
                finish_reason=FINISH_STOP,
                annotations={"embedding": vec, "input_tokens": len(req.token_ids)},
            )
            return
        limit = req.stop.max_tokens or len(req.token_ids)
        produced = 0
        for tid in req.token_ids:
            if context.is_stopped():
                return
            if produced >= limit:
                yield BackendOutput(finish_reason=FINISH_LENGTH, cumulative_tokens=produced)
                return
            produced += 1
            # deterministic synthetic logprobs (chosen token is always the
            # argmax) so API-surface tests can exercise the full
            # engine->Backend->delta logprob path without a real model
            lps = None
            tlps = None
            if req.sampling.want_logprobs or req.sampling.logprobs > 0:
                lps = [-0.25]
                tlps = [{tid: -0.25, (tid + 1) % 512: -1.25, (tid + 2) % 512: -2.25}]
            yield BackendOutput(
                token_ids=[tid], cumulative_tokens=produced,
                logprobs=lps, top_logprobs=tlps,
            )
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
        yield BackendOutput(finish_reason=FINISH_STOP, cumulative_tokens=produced)
