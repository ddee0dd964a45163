"""The embeddings request (``op: embed``) inside TorchEngine (on the CPU):
each family's attention goes through its kernel's wrapper, flash-extend
(llama, Qwen3-MoE), unified (Gemma, gpt-oss) or latent (MLA); a chunked
input without free pages gets the reference's error while a short one
needs none; and an embedding served while a request decodes in horizons
changes neither (tests/test_torch_embed.py holds the vectors against
TpuEngine's).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from dynamo_tpu_torch.engine import engine as eng
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context
from test_torch_embed import ENGINE, KERNEL, LONG, SHORT, TOL, _configs, _embed, _embed_req


@pytest.mark.parametrize("preset", list(KERNEL))
def test_embedding_attention_goes_through_the_family_kernel(preset, monkeypatch):
    _, tcfg = _configs(preset)
    wrappers = {"flash": (eng.cuda_prefill, "flash_extend_attention"),
                "unified": (eng.cuda_unified, "ragged_paged_attention"),
                "latent": (eng.cuda_mla, "latent_paged_attention"),
                "decode": (eng.cuda_attention, "paged_decode_attention")}
    calls = {k: 0 for k in wrappers}

    def spy(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    for kind, (mod, name) in wrappers.items():
        monkeypatch.setattr(mod, name, spy(kind, getattr(mod, name)))
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", decode_steps=1,
                                           decode_pipeline=1, **ENGINE))

    async def main():
        for t in (SHORT, LONG):
            await _embed(engine, _embed_req(PreprocessedRequest, "e", t), Context())

    try:
        asyncio.run(main())
    finally:
        engine.stop()
    want = KERNEL[preset]
    assert calls[want] > 0, calls
    assert all(n == 0 for k, n in calls.items() if k != want), calls


def test_long_embedding_without_pages_is_refused_with_the_reference_error():
    _, tcfg = _configs("tiny")
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", decode_steps=1,
                                           decode_pipeline=1,
                                           **{**ENGINE, "num_blocks": 24}))

    async def main():
        # pages other requests hold: 13 free, 18 needed
        held = engine.allocator.allocate(10)
        with pytest.raises(ValueError, match="no KV capacity for a 70-token embedding"):
            await _embed(engine, _embed_req(PreprocessedRequest, "e", LONG), Context())
        # a short one needs no pages
        short = await _embed(engine, _embed_req(PreprocessedRequest, "s", SHORT), Context())
        engine.allocator.release(held)
        return short, await _embed(engine, _embed_req(PreprocessedRequest, "e", LONG),
                                   Context())

    try:
        short, long = asyncio.run(main())
    finally:
        engine.stop()
    assert len(short["embedding"]) == len(long["embedding"]) == tcfg.hidden_size
    assert engine.allocator.free_blocks == 23


def test_embedding_between_decode_steps_leaves_the_stream_alone():
    """An embedding served while a request decodes: the stream equals the
    same request's stream alone, and the embedding equals the one an idle
    engine gives."""
    # two layers keep the horizons quick when the CPU is shared
    tcfg = dataclasses.replace(_configs("tiny")[1], num_layers=2)

    def gen_req():
        return PreprocessedRequest(request_id="g", model="m", token_ids=SHORT,
                                   stop=StopConditions(max_tokens=24),
                                   sampling=SamplingOptions(temperature=0.0))

    async def alone(engine):
        toks = [t async for o in engine.generate(gen_req(), Context()) for t in o.token_ids]
        vec = await _embed(engine, _embed_req(PreprocessedRequest, "e", LONG), Context())
        return toks, vec["embedding"]

    async def together(engine):
        async def run():
            return [t async for o in engine.generate(gen_req(), Context())
                    for t in o.token_ids]
        task = asyncio.ensure_future(run())
        await asyncio.sleep(0)
        vec = await _embed(engine, _embed_req(PreprocessedRequest, "e", LONG), Context())
        return await task, vec["embedding"]

    out = []
    for fn in (alone, together):
        engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", decode_steps=4,
                                               decode_pipeline=2, **ENGINE))
        try:
            out.append(asyncio.run(fn(engine)))
        finally:
            engine.stop()
    (toks_a, vec_a), (toks_b, vec_b) = out
    assert len(toks_a) == 24 and toks_b == toks_a
    assert np.max(np.abs(np.asarray(vec_a) - np.asarray(vec_b))) < TOL
