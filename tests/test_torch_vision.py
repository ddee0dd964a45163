"""Vision prompts in the port: the tower (models/vision.py), the encoder
cache (llm/encoder_cache.py) and TorchEngine's multimodal path, on the CPU
and in float32, against the JAX package on the same weights.

The tower is held to ``dynamo_tpu.models.vision`` within 1e-5 at the tiny
and the default configuration; the engine to ``TpuEngine(vision=...)``
(the tower's and the language model's weights carried across through
numpy): identical greedy streams for one- and two-image prompts, a prompt
whose image run straddles a prefill chunk boundary, and prior token ids.
Also the reference's own multimodal invariants (tests/test_multimodal.py):
different images change the stream, a repeated image hits the encoder
cache, the validation errors, and no prefix caching of image prompts;
plus what the port adds: a text-only request on a vision engine streams
the text engine's tokens, a vision engine runs no fused mixed step, a
penalised request whose prompt holds the placeholder id, and the
construction checks.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import vision as jvision
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import (
    TorchEngine,
    TorchEngineConfig,
    UnsupportedRequestError,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy, vision_params_from_numpy
from dynamo_tpu_torch.llm.encoder_cache import EncoderCacheManager, content_hash
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import vision as tvision
from dynamo_tpu_torch.models.gemma import GemmaConfig
from dynamo_tpu_torch.models.moe import MoeConfig
from dynamo_tpu_torch.runtime import Context

IMG = tvision.IMAGE_TOKEN_ID
MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=96)
ENGINE = dict(num_blocks=128, block_size=16, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), seed=0)
TOL = 1e-5


def _image(seed, size=28):
    return np.random.default_rng(seed).random((size, size, 3)).astype(np.float32)


def _tower(jcfg, seed=0):
    """(the JAX tower's params, the same as numpy)."""
    jp = jvision.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def _port_cfg(jcfg) -> tvision.VisionConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    return tvision.VisionConfig(dtype=torch.float32, **fields)


# ------------------------------------------------------------------ tower
def test_patchify_equals_the_reference():
    jcfg = jvision.VisionConfig.tiny(out_hidden_size=64)
    img = _image(0)
    want = np.asarray(jvision.patchify(jcfg, jnp.asarray(img)))
    got = tvision.patchify(_port_cfg(jcfg), torch.from_numpy(img)).numpy()
    assert got.shape == (jcfg.num_patches, jcfg.patch_dim)
    np.testing.assert_array_equal(got, want)
    p = jcfg.patch_size
    np.testing.assert_array_equal(got[0], img[:p, :p, :].reshape(-1))


@pytest.mark.parametrize("config", ["tiny", "default"])
def test_encode_equals_the_reference(config):
    jcfg = (jvision.VisionConfig.tiny(out_hidden_size=64) if config == "tiny"
            else jvision.VisionConfig(out_hidden_size=64))
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    jp, tree = _tower(jcfg, seed=3)
    tcfg = _port_cfg(jcfg)
    tp = vision_params_from_numpy(tree, tcfg, device="cpu")
    for seed in (0, 1):
        img = _image(seed, jcfg.image_size)
        want = np.asarray(jvision.encode(jp, jcfg, jnp.asarray(img)))
        got = tvision.encode(tp, tcfg, torch.from_numpy(img)).numpy()
        assert got.shape == (jcfg.num_patches, 64)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_init_params_and_weight_carrying():
    tcfg = tvision.VisionConfig.tiny(out_hidden_size=64)
    gen = torch.Generator().manual_seed(0)
    p = tvision.init_params(tcfg, gen, "cpu")
    _, tree = _tower(jvision.VisionConfig.tiny(out_hidden_size=64))
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    assert p["patch_embed"].dtype == torch.bfloat16
    bad = dict(tree, extra=tree["final_norm"])
    with pytest.raises(ValueError, match="vision parameters"):
        vision_params_from_numpy(bad, tcfg, device="cpu")


def test_encoder_cache_lru_capacity_and_hits():
    c = EncoderCacheManager(capacity_bytes=3000)
    a = np.zeros((10, 25), np.float32)   # 1000 bytes
    for i in range(4):
        c.set(f"k{i}", a + i)
    assert len(c) == 3 and c.used_bytes == 3000
    assert c.get("k0") is None           # evicted, least recent
    assert c.get("k3") is not None
    c.get("k1")                          # k1 now most recent: k2 goes next
    c.set("k4", a)
    assert c.get("k2") is None and c.get("k1") is not None
    c.set("big", np.zeros(1000, np.float32))   # larger than the cache: never admitted
    assert c.get("big") is None
    assert c.stats() == {"entries": 3, "bytes": 3000, "hits": 3, "misses": 3}
    assert content_hash(b"img") == content_hash(b"img") != content_hash(b"img2")


# ------------------------------------------------------------------ engine
def _mm_req(cls_req, cls_samp, cls_stop, rid, tokens, images, n=6, prior=(), **samp):
    return cls_req(
        request_id=rid, model="m", token_ids=list(tokens), prior_token_ids=list(prior),
        stop=cls_stop(max_tokens=n, ignore_eos=True),
        sampling=cls_samp(temperature=samp.pop("temperature", 0.0), **samp),
        annotations={"images": [{"data": im.tobytes(), "shape": list(im.shape)}
                                for im in images]} if images else {},
    )


def _text(seed, n):
    return np.random.default_rng(seed).integers(0, 128, size=n).tolist()


NP = 4   # patches of the tiny tower
SCENARIOS = {
    "one image": (_text(1, 8) + [IMG] * NP + _text(2, 3), [_image(10)], ()),
    "two images": (_text(3, 5) + [IMG] * NP + _text(4, 6) + [IMG] * NP + [7],
                   [_image(11), _image(12)], ()),
    # 150 tokens over a largest bucket of 64: the image run spans 62..65,
    # across the first chunk boundary
    "chunked": (_text(5, 62) + [IMG] * NP + _text(6, 84), [_image(13)], ()),
    "prior tokens": (_text(7, 9) + [IMG] * NP, [_image(14)], _text(8, 5)),
    "text only": (_text(9, 20), [], ()),
}


async def _serve(engine, cls, scenarios, ctx):
    out = {}
    for name, (tokens, images, prior) in scenarios.items():
        toks, cached = [], None
        async for item in engine.generate(_mm_req(*cls, name, tokens, images, prior=prior),
                                          ctx()):
            toks.extend(item.token_ids)
            if "cached_tokens" in (item.annotations or {}):
                cached = item.annotations["cached_tokens"]
        out[name] = (toks, cached)
    return out


@pytest.fixture(scope="module")
def weights():
    jm = jllama.LlamaConfig(dtype=jnp.float32, **MODEL)
    jv = dataclasses.replace(jvision.VisionConfig.tiny(out_hidden_size=64), dtype=jnp.float32)
    jparams = jllama.init_params(jax.random.PRNGKey(5), jm)
    return jm, jv, jparams, jax.tree.map(np.asarray, jparams)


def _engine(weights, vision=True, vision_params=None, **kw):
    jm, jv, _, tree = weights
    tm = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    cfg = TorchEngineConfig(model=tm, device="cpu", vision=_port_cfg(jv) if vision else None,
                            **{"decode_steps": 4, "decode_pipeline": 1, **ENGINE, **kw})
    return TorchEngine(cfg, params=params_from_numpy(tree, tm, device="cpu"),
                       vision_params=vision_params)


@pytest.fixture(scope="module")
def streams(weights):
    jm, jv, jparams, _ = weights

    async def main():
        jeng = TpuEngine(TpuEngineConfig(model=jm, use_pallas=False, vision=jv,
                                         decode_steps=1, decode_pipeline=1, **ENGINE),
                         params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        tvp = vision_params_from_numpy(jax.tree.map(np.asarray, jeng.vision_params),
                                       _port_cfg(jv), device="cpu")
        teng = _engine(weights, vision_params=tvp)
        text = _engine(weights, vision=False)
        try:
            want = await _serve(jeng, (JRequest, JSampling, JStop), SCENARIOS, JContext)
            got = await _serve(teng, (PreprocessedRequest, SamplingOptions, StopConditions),
                               SCENARIOS, Context)
            plain = await _serve(text, (PreprocessedRequest, SamplingOptions, StopConditions),
                                 {"text only": SCENARIOS["text only"]}, Context)
            return want, got, plain, teng
        finally:
            jeng.stop()
            teng.stop()
            text.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_streams_equal_tpu_engine(streams, name):
    want, got, _, _ = streams
    assert len(got[name][0]) == 6
    assert got[name][0] == want[name][0]


def test_text_only_request_streams_what_a_text_engine_streams(streams):
    _, got, plain, engine = streams
    assert got["text only"][0] == plain["text only"][0]
    assert engine.step_counts["mixed"] == 0


def test_images_change_the_stream_and_hit_the_encoder_cache(weights):
    black = np.zeros((28, 28, 3), np.float32)
    white = np.ones((28, 28, 3), np.float32)
    tokens = _text(20, 8) + [IMG] * NP + [9, 10]

    async def main():
        e = _engine(weights)
        try:
            out = []
            for rid, img in (("a", black), ("b", white), ("a2", black)):
                got = await _serve(e, (PreprocessedRequest, SamplingOptions, StopConditions),
                                   {rid: (tokens, [img], ())}, Context)
                out.append(got[rid])
            return out, e.encoder_cache.stats()
        finally:
            e.stop()

    (a, b, a2), stats = asyncio.run(main())
    assert a[0] != b[0], "different images must change the greedy stream"
    assert a[0] == a2[0], "the same image must reproduce the stream"
    assert stats["hits"] == 1 and stats["misses"] == 2


def test_validation_errors(weights):
    async def main():
        text = _engine(weights, vision=False)
        vis = _engine(weights)
        try:
            req = _mm_req(PreprocessedRequest, SamplingOptions, StopConditions, "x",
                          _text(1, 4) + [IMG] * NP, [_image(0)])
            with pytest.raises(UnsupportedRequestError, match="vision tower"):
                async for _ in text.generate(req, Context()):
                    pass
            # the placeholder id is not a token of a text engine
            plain = _mm_req(PreprocessedRequest, SamplingOptions, StopConditions, "y",
                            _text(1, 4) + [IMG], [])
            with pytest.raises(ValueError, match="outside the vocab"):
                async for _ in text.generate(plain, Context()):
                    pass
            stripped = _mm_req(PreprocessedRequest, SamplingOptions, StopConditions, "z",
                               _text(1, 10), [_image(0)])
            with pytest.raises(ValueError, match="placeholder runs"):
                async for _ in vis.generate(stripped, Context()):
                    pass
            short = _mm_req(PreprocessedRequest, SamplingOptions, StopConditions, "w",
                            _text(1, 4) + [IMG] * (NP - 1), [_image(0)])
            with pytest.raises(ValueError, match="patch embeddings"):
                async for _ in vis.generate(short, Context()):
                    pass
        finally:
            text.stop()
            vis.stop()

    asyncio.run(main())


def test_image_prompts_skip_the_prefix_cache(weights):
    """Identical placeholder prefixes with different images must not share
    KV: image prompts never enter, nor match, the prefix cache."""
    tokens = _text(21, 40) + [IMG] * NP + _text(22, 20)

    async def main():
        e = _engine(weights)
        try:
            cls = (PreprocessedRequest, SamplingOptions, StopConditions)
            a = await _serve(e, cls, {"a": (tokens, [_image(1)], ())}, Context)
            blocks = e.allocator.cached_blocks
            b = await _serve(e, cls, {"b": (tokens, [_image(2)], ())}, Context)
            return a["a"], b["b"], blocks, e.allocator.cached_blocks
        finally:
            e.stop()

    a, b, after_a, after_b = asyncio.run(main())
    assert after_a == 0 and after_b == 0
    assert a[1] == 0 and b[1] == 0


def test_penalised_request_with_the_placeholder_id(weights):
    """The prompt-mask row drops ids outside the vocab (the placeholder),
    as the reference's does: a penalised image request is served."""
    tokens = _text(30, 6) + [IMG] * NP + [3, 3, 5]

    async def main():
        e = _engine(weights)
        try:
            req = _mm_req(PreprocessedRequest, SamplingOptions, StopConditions, "p", tokens,
                          [_image(3)], n=5, presence_penalty=0.5, repetition_penalty=1.3)
            toks = []
            async for out in e.generate(req, Context()):
                toks.extend(out.token_ids)
            return toks, e.prompt_masks.clone()
        finally:
            e.stop()

    toks, masks = asyncio.run(main())
    assert len(toks) == 5 and all(0 <= t < 128 for t in toks)
    assert masks[:, 3].any() and masks.sum() <= len(set(tokens) - {IMG})


def test_construction_checks():
    # a Gemma main is served (tests/test_torch_vision_families.py); a
    # Qwen3-MoE main is refused, as in the reference
    gemma = GemmaConfig.tiny_gemma3(vocab_size=128)
    TorchEngine(TorchEngineConfig(model=gemma, device="cpu", decode_steps=1,
                                  vision=tvision.VisionConfig.tiny(
                                      out_hidden_size=gemma.hidden_size))).stop()
    moe = MoeConfig.tiny_moe(vocab_size=128)
    with pytest.raises(ValueError, match="Qwen3-MoE main is refused.*ROADMAP"):
        TorchEngine(TorchEngineConfig(model=moe, device="cpu",
                                      vision=tvision.VisionConfig.tiny(
                                          out_hidden_size=moe.hidden_size)))
    with pytest.raises(ValueError, match="out_hidden_size"):
        TorchEngine(TorchEngineConfig(model=tllama.LlamaConfig(dtype=torch.float32, **MODEL),
                                      device="cpu", vision=tvision.VisionConfig.tiny(32)))


def test_a_vision_engine_runs_no_mixed_step(weights):
    """A prompt arriving while another request decodes: a text engine
    fuses its chunks with the decode rows, a vision engine prefills them
    split (the reference's engine does not thread the splice through the
    packed buffer); both stream the same tokens."""
    async def run(e):
        first = asyncio.Event()
        cls = (PreprocessedRequest, SamplingOptions, StopConditions)

        async def one(rid, tokens, n):
            toks = []
            async for out in e.generate(_mm_req(*cls, rid, tokens, [], n=n), Context()):
                toks.extend(out.token_ids)
                first.set()
            return toks

        try:
            lead = asyncio.ensure_future(one("lead", _text(40, 9), 24))
            await first.wait()
            late = await one("late", _text(41, 150), 6)
            return [await lead, late], dict(e.step_counts)
        finally:
            e.stop()

    text, text_steps = asyncio.run(run(_engine(weights, vision=False)))
    vis, vis_steps = asyncio.run(run(_engine(weights)))
    assert text_steps["mixed"] > 0 and vis_steps["mixed"] == 0
    assert vis == text
