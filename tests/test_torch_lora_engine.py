"""Multi-LoRA in the port's engine (TorchEngine ``lora_max_adapters``)
against TpuEngine's, on the CPU, with the adapters of
tests/test_torch_lora.py (all seven targets).

- base, adapter-a and adapter-b requests queued at once on prompts that
  share no prefix across adapters (the reference reuses a base request's
  prefix blocks for an adapter request), then a 150-token adapter prompt
  (chunked) and a sampled one, at ``decode_steps`` 1 and 4: streams equal
  TpuEngine's; the base rows equal a LoRA-less engine's, the adapter rows
  do not;
- the prefix salt: an adapter request after a base request on the same
  40-token prompt streams what the adapter streams with nothing cached
  (the reference's stream differs: it reused the base request's two
  blocks), the adapter's next request reuses its own blocks, and an
  adapter reloaded under its name with new weights matches none of its
  old blocks;
- a vision request with an adapter, against TpuEngine;
- the refusals: an unknown adapter, an engine without LoRA, a family
  other than dense llama, LoRA with spec decoding.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import vision as jvision
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import vision_params_from_numpy
from dynamo_tpu_torch.models import vision as tvision
from dynamo_tpu_torch.models.gemma import GemmaConfig
from dynamo_tpu_torch.models.vision import IMAGE_TOKEN_ID
from test_torch_lora import ENGINE, MODEL, TCFG, _adapter_weights
from torch_feature_engines import Weights, collect, request, serve, tokens

# ------------------------------------------------------------------ the engine
ADAPTERS = {"a": dict(seed=5, scale=2.0), "b": dict(seed=9, scale=2.0)}
BATCHES = [
    [("base", tokens(1, 20, 128), 12, {}), ("a", tokens(2, 40, 128), 12, {"lora": "a"}),
     ("b", tokens(3, 12, 128), 12, {"lora": "b"})],
    [("a-long", tokens(4, 150, 128), 10, {"lora": "a"}),
     ("b-sampled", tokens(5, 30, 128), 12, {"lora": "b", "temperature": 0.8, "seed": 7}),
     ("base-2", tokens(6, 25, 128), 12, {})],
]
RIDS = [r[0] for b in BATCHES for r in b]


def _batches(lora=True):
    return [[(rid, toks, n, dict(ann={"lora": kw["lora"]} if lora and "lora" in kw else {},
                                 ignore_eos=True,
                                 **{k: v for k, v in kw.items() if k != "lora"}))
             for rid, toks, n, kw in batch] for batch in BATCHES]


def _load(engine, **over):
    for name, kw in ADAPTERS.items():
        engine.lora.load(name, _adapter_weights(TCFG, **{**kw, **over.get(name, {})}))
    return engine


@pytest.fixture(scope="module")
def weights():
    return Weights(MODEL)


@pytest.fixture(scope="module")
def streams(weights):
    ref = dict(zip(RIDS, serve(_load(weights.jax_engine(ENGINE)), _batches())))
    port = {}
    for steps in (1, 4):
        e = _load(weights.torch_engine(ENGINE, decode_steps=steps, decode_pipeline=1))
        port[steps] = dict(zip(RIDS, serve(e, _batches())))
        port[steps]["_engine"] = e
    plain_cfg = {k: v for k, v in ENGINE.items() if not k.startswith("lora")}
    plain = dict(zip(RIDS, serve(weights.torch_engine(plain_cfg, decode_steps=4,
                                                      decode_pipeline=1), _batches(False))))
    return ref, port, plain


@pytest.mark.parametrize("steps", [1, 4])
def test_streams_equal_tpu_engine(streams, steps):
    ref, port, _ = streams
    for rid in RIDS:
        assert port[steps][rid]["tokens"] == ref[rid]["tokens"], rid
    e = port[steps]["_engine"]
    assert e.step_counts["mixed"] > 0
    assert (e.step_counts["horizon"] > 0) == (steps > 1)


def test_adapters_change_their_rows_only(streams):
    ref, port, plain = streams
    for rid in ("base", "base-2"):
        assert port[4][rid]["tokens"] == plain[rid]["tokens"], rid
    for rid in ("a", "b", "a-long", "b-sampled"):
        assert port[4][rid]["tokens"] != plain[rid]["tokens"], rid


PROMPT40 = BATCHES[0][1][1]      # adapter-a's 40-token prompt in the first batch


def _salt_runs(engine, order, n=12):
    async def main():
        try:
            return [await collect(engine, request(isinstance(engine, TpuEngine), rid, PROMPT40,
                                                  n, ann=ann, ignore_eos=True))
                    for rid, ann in order]
        finally:
            engine.stop()

    return asyncio.run(main())


def test_adapter_requests_never_reuse_base_blocks(weights, streams):
    """Base, then adapter-a on the same 40-token prompt (two full blocks
    the base request committed), against adapter-a with nothing cached
    (the first batch of the streams, where no other request shares its
    prefix)."""
    ref, port, _ = streams
    order = [("base", {}), ("a", {"lora": "a"})]
    ref_after = _salt_runs(_load(weights.jax_engine(ENGINE)), order)[1]
    # the reference's fault: its adapter request reused the base blocks
    assert ref_after["cached"] == 32 and ref_after["tokens"] != ref["a"]["tokens"]
    e = _load(weights.torch_engine(ENGINE, decode_steps=4, decode_pipeline=1))
    base, after, again = _salt_runs(e, order + [("a2", {"lora": "a"})])
    assert base["cached"] == 0 and after["cached"] == 0
    assert after["tokens"] == port[4]["a"]["tokens"] == ref["a"]["tokens"]
    # the adapter's own blocks are reused by its next request
    assert again["cached"] == 32 and again["tokens"] == after["tokens"]


def test_a_reloaded_adapter_matches_none_of_its_old_blocks(weights):
    e = _load(weights.torch_engine(ENGINE, decode_steps=1, decode_pipeline=1))
    new = {"a": dict(seed=21)}

    async def main():
        try:
            first = await collect(e, request(False, "a1", PROMPT40, 6, ann={"lora": "a"}))
            _load(e, **new)
            return first, await collect(e, request(False, "a2", PROMPT40, 6,
                                                   ann={"lora": "a"}))
        finally:
            e.stop()

    first, reloaded = asyncio.run(main())
    (fresh,) = _salt_runs(_load(weights.torch_engine(ENGINE, decode_steps=1,
                                                     decode_pipeline=1), **new),
                          [("a", {"lora": "a"})], n=6)
    assert first["cached"] == 0 and reloaded["cached"] == 0
    assert reloaded["tokens"] == fresh["tokens"] != first["tokens"]


def test_a_vision_request_with_an_adapter(weights):
    jv = dataclasses.replace(jvision.VisionConfig.tiny(out_hidden_size=64), dtype=jnp.float32)
    tv = tvision.VisionConfig(dtype=torch.float32, **{
        f.name: getattr(jv, f.name) for f in dataclasses.fields(jv) if f.name != "dtype"})
    image = np.random.default_rng(10).random((28, 28, 3)).astype(np.float32)
    prompt = tokens(12, 8, 128) + [IMAGE_TOKEN_ID] * 4 + tokens(13, 5, 128)
    ann = {"lora": "a", "images": [{"data": image.tobytes(), "shape": list(image.shape)}]}
    jeng = _load(TpuEngine(TpuEngineConfig(model=weights.jcfg, use_pallas=False, vision=jv,
                                           decode_steps=1, decode_pipeline=1, **ENGINE),
                           params=weights.jparams,
                           mesh=make_mesh(tp=1, devices=jax.devices()[:1])))
    vp = vision_params_from_numpy(jax.tree.map(np.asarray, jeng.vision_params), tv,
                                  device="cpu")
    teng = _load(weights.torch_engine(ENGINE, decode_steps=4, decode_pipeline=1, vision=tv))
    teng.vision_params = vp
    batch = [[("v", prompt, 8, dict(ann=ann, ignore_eos=True))]]
    (want,), (got,) = serve(jeng, batch), serve(teng, batch)
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 8


# ------------------------------------------------------------------ refusals
def test_refusals(weights):
    with pytest.raises(ValueError, match="llama/qwen dense family only"):
        TorchEngine(TorchEngineConfig(model=GemmaConfig.tiny_gemma3(vocab_size=128),
                                      device="cpu", **ENGINE))
    with pytest.raises(ValueError, match="no vision/LoRA"):
        weights.torch_engine(ENGINE, spec_draft=TCFG, decode_steps=4, decode_pipeline=1)
    e = _load(weights.torch_engine(ENGINE, decode_steps=1, decode_pipeline=1))
    off = weights.torch_engine({k: v for k, v in ENGINE.items() if not k.startswith("lora")},
                               decode_steps=1, decode_pipeline=1)

    async def main():
        try:
            with pytest.raises(ValueError, match="unknown LoRA adapter 'ghost'"):
                await collect(e, request(False, "r", [1, 2, 3], 4, ann={"lora": "ghost"}))
            with pytest.raises(ValueError, match="engine built without LoRA support"):
                await collect(off, request(False, "r", [1, 2, 3], 4, ann={"lora": "a"}))
        finally:
            e.stop()
            off.stop()

    asyncio.run(main())
