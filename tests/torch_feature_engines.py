"""Shared set-up of the per-request feature tests (not a test module):
tests/test_torch_logits_processing.py, test_torch_guided.py and
test_torch_lora.py hold TorchEngine(device="cpu") to TpuEngine on the same
tiny float32 llama weights (JAX ``init_params`` carried across through
numpy) and the same requests.

The reference engine runs one eager decode step a tick (its greedy and
seeded streams do not depend on the schedule); the port runs that and
its decode horizons.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import Context


class Weights:
    """One tiny llama's JAX config and params, and the port's config and
    the same params as numpy."""

    def __init__(self, model: dict, seed: int = 5):
        self.model = model
        self.jcfg = jllama.LlamaConfig(dtype=jnp.float32, **model)
        self.tcfg = tllama.LlamaConfig(dtype=torch.float32, **model)
        self.jparams = jllama.init_params(jax.random.PRNGKey(seed), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)

    def jax_engine(self, engine: dict, **kw) -> TpuEngine:
        """TpuEngine with one decode step a tick; ``kw`` splits into the
        config's fields and the constructor's (``guided_vocab``)."""
        ctor = {k: kw.pop(k) for k in ("guided_vocab",) if k in kw}
        cfg = TpuEngineConfig(model=self.jcfg, use_pallas=False,
                              **{"decode_steps": 1, "decode_pipeline": 1, **engine, **kw})
        return TpuEngine(cfg, params=self.jparams,
                         mesh=make_mesh(tp=1, devices=jax.devices()[:1]), **ctor)

    def torch_engine(self, engine: dict, **kw) -> TorchEngine:
        ctor = {k: kw.pop(k) for k in ("guided_vocab", "draft_params") if k in kw}
        model = kw.pop("model", self.tcfg)
        cfg = TorchEngineConfig(model=model, device="cpu", **{**engine, **kw})
        return TorchEngine(cfg, params=params_from_numpy(self.tree, model, device="cpu"),
                           **ctor)


def request(jax_side: bool, rid: str, tokens, n: int, stop=(), ann=None, prior=(),
            ignore_eos: bool = False, **sampling):
    """One request of either package's protocol classes."""
    req, samp, stp = ((JRequest, JSampling, JStop) if jax_side
                      else (PreprocessedRequest, SamplingOptions, StopConditions))
    return req(request_id=rid, model="m", token_ids=list(tokens),
               prior_token_ids=list(prior),
               stop=stp(max_tokens=n, stop_token_ids=list(stop), ignore_eos=ignore_eos),
               sampling=samp(temperature=sampling.pop("temperature", 0.0), **sampling),
               annotations=dict(ann or {}))


async def collect(engine, req) -> dict:
    """A request's tokens, logprobs, cached tokens and finish reason."""
    ctx = JContext() if isinstance(engine, TpuEngine) else Context()
    out = {"tokens": [], "logprobs": [], "cached": None, "finish": None}
    async for item in engine.generate(req, ctx):
        out["tokens"].extend(item.token_ids)
        out["logprobs"].extend(item.logprobs or [])
        if "cached_tokens" in (item.annotations or {}):
            out["cached"] = item.annotations["cached_tokens"]
        out["finish"] = item.finish_reason or out["finish"]
    return out


def serve(engine, batches) -> list:
    """Each batch of (rid, tokens, n, kwargs) requests queued at once,
    batch after batch, in one event loop (the engine's loop task lives in
    it); returns every request's ``collect`` result, in order."""
    jax_side = isinstance(engine, TpuEngine)

    async def main():
        out = []
        try:
            for batch in batches:
                out += await asyncio.gather(*(
                    collect(engine, request(jax_side, rid, toks, n, **kw))
                    for rid, toks, n, kw in batch))
        finally:
            engine.stop()
        return out

    return asyncio.run(main())


def tokens(seed: int, n: int, vocab: int) -> list:
    return np.random.default_rng(seed).integers(0, vocab, size=n).tolist()
