"""Vision prompts beyond the dense llama family, on the CPU, float32.

The reference's Gemma, gpt-oss and MLA forwards take ``inputs_embeds``
(models/gemma.py, gptoss.py, mla.py) and its engine refuses vision only
on Qwen3-MoE. Held here against the JAX package on the same numpy inputs:

- each family's forward with ``inputs_embeds`` against the reference
  forward (Gemma scales the spliced embeddings by sqrt(hidden) in the
  model dtype, as its token embeddings: the splice of a prompt's own token
  embeddings gives the token forward exactly);
- image-prompt greedy streams of ``TorchEngine(vision=...)`` with Gemma 3,
  gpt-oss and MLA mains equal ``TpuEngine(vision=...)``'s, the tower's
  weights carried across by ``weights.vision_params_from_numpy``.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gemma as tg
import test_torch_gptoss as tgo
import test_torch_mla as tm
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.models import gemma as jgemma
from dynamo_tpu.models import gptoss as jgptoss
from dynamo_tpu.models import mla as jmla
from dynamo_tpu.models import vision as jvision
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy, vision_params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import gemma as tgemma
from dynamo_tpu_torch.models import gptoss as tgptoss
from dynamo_tpu_torch.models import mla as tmla
from dynamo_tpu_torch.models import vision as tvision
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.runtime import Context

TOL = 1e-4
IMG = tvision.IMAGE_TOKEN_ID
FAMILIES = {
    # name: (configs, numpy weights, JAX forward, port forward)
    "gemma3": (lambda: tg._configs("tiny_gemma3"), tg._numpy_params, jgemma.forward,
               tgemma.forward),
    "gptoss": (tgo._configs, tgo._numpy_params, jgptoss.forward, tgptoss.forward),
    "mla": (lambda: tm._configs("tiny_mla"), tm._numpy_params, jmla.forward, tmla.forward),
}


def _family(name, seed):
    configs, numpy_params, jfwd, tfwd = FAMILIES[name]
    jcfg, tcfg = configs()
    return jcfg, tcfg, numpy_params(jcfg, seed=seed), jfwd, tfwd


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_forward_with_inputs_embeds_matches_jax(name):
    jcfg, tcfg, tree, jfwd, tfwd = _family(name, seed=41)
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    S = 11
    rng = np.random.default_rng(42)
    embeds = rng.standard_normal((S, tcfg.hidden_size)).astype(np.float32)
    ids = rng.integers(0, tcfg.vocab_size, S)
    pos = np.arange(S)
    # jitted: one compile instead of op-by-op dispatch
    want = jax.jit(lambda p, t, x, e: jfwd(
        p, jcfg, t, x, lambda q, k, v, i, **kw: jatt.causal_attention(q, k, v, **kw),
        inputs_embeds=e))(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                          jnp.asarray(pos), jnp.asarray(embeds))

    def attend(q, k, v, i, **kw):
        return tatt.causal_attention(q, k, v, **kw)

    with torch.no_grad():
        got = tfwd(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), attend,
                   inputs_embeds=torch.from_numpy(embeds))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        # a prompt's own token embeddings spliced in give the token forward
        # exactly (Gemma's sqrt(hidden) applies to both alike)
        own = tparams["embed"][torch.from_numpy(ids)]
        by_ids = tfwd(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), attend)
        spliced = tfwd(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), attend,
                       inputs_embeds=own)
        assert torch.equal(by_ids, spliced)
        if name == "gemma3":
            # left unscaled, the splice is another model
            unscaled = tfwd(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pos),
                            attend, inputs_embeds=own / tgemma._rounded(
                                tcfg.hidden_size ** 0.5, own.dtype))
            assert not torch.allclose(unscaled, by_ids, atol=1e-2)


# ------------------------------------------------------------ engines
ENGINE = dict(num_blocks=128, block_size=16, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), seed=0)
NP = 4   # patches of the tiny tower


def _image(seed, size=28):
    return np.random.default_rng(seed).random((size, size, 3)).astype(np.float32)


def _text(seed, n):
    return np.random.default_rng(seed).integers(0, 500, size=n).tolist()


# two images, and a prompt whose image run straddles the first 64-token chunk
PROMPTS = {"two images": (_text(3, 5) + [IMG] * NP + _text(4, 6) + [IMG] * NP + [7],
                          [_image(11), _image(12)]),
           "chunked": (_text(5, 62) + [IMG] * NP + _text(6, 20), [_image(13)])}
N = 6


def _req(cls, rid, tokens, images):
    return cls[0](request_id=rid, model="m", token_ids=list(tokens),
                  stop=cls[2](max_tokens=N, ignore_eos=True),
                  sampling=cls[1](temperature=0.0),
                  annotations={"images": [{"data": im.tobytes(), "shape": list(im.shape)}
                                          for im in images]})


async def _serve(engine, cls, ctx):
    out = {}
    for name, (tokens, images) in PROMPTS.items():
        out[name] = [t async for o in engine.generate(_req(cls, name, tokens, images), ctx())
                     for t in o.token_ids]
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_image_prompt_streams_equal_tpu_engine(name):
    jcfg, tcfg, tree, _, _ = _family(name, seed=43)
    jv = dataclasses.replace(jvision.VisionConfig.tiny(out_hidden_size=jcfg.hidden_size),
                             dtype=jnp.float32)
    tv = tvision.VisionConfig(dtype=torch.float32, **{
        f.name: getattr(jv, f.name) for f in dataclasses.fields(jv) if f.name != "dtype"})

    async def main():
        jeng = TpuEngine(TpuEngineConfig(model=jcfg, use_pallas=False, vision=jv,
                                         decode_steps=1, decode_pipeline=1, **ENGINE),
                         params=jax.tree.map(jnp.asarray, tree),
                         mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        tvp = vision_params_from_numpy(jax.tree.map(np.asarray, jeng.vision_params), tv,
                                       device="cpu")
        teng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", vision=tv,
                                             decode_steps=4, decode_pipeline=1, **ENGINE),
                           params=params_from_numpy(tree, tcfg, device="cpu"),
                           vision_params=tvp)
        try:
            want = await _serve(jeng, (JRequest, JSampling, JStop), JContext)
            got = await _serve(teng, (PreprocessedRequest, SamplingOptions, StopConditions),
                               Context)
            return want, got, teng
        finally:
            jeng.stop()
            teng.stop()

    want, got, engine = asyncio.run(main())
    assert all(len(t) == N for t in got.values())
    assert got == want
    assert engine.encoder_cache.stats()["misses"] == 3
    assert engine.step_counts["prefill"] >= 3 and engine.step_counts["mixed"] == 0
