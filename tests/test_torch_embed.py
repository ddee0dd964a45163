"""The embeddings request (``op: embed``) of TorchEngine against
TpuEngine's: the last token's final hidden state, float32, L2-normalised.

For each family's tiny preset (llama, Gemma 3, gpt-oss, Qwen3-MoE, MLA;
float32 weights from TpuEngine's own random init, through numpy and
``params_from_numpy``) both engines embed a short input (one prefill
bucket: one forward over its own K/V, no pages) and a chunked one (70
tokens over a largest bucket of 32: three chunks over temporary pages),
on float and int8 caches (MLA: float only; its cache has no int8 form).
Vectors agree within 1e-5, except the chunked ones on an int8 cache:
there the two engines' K/V, which differ by float32 rounding (~1e-7),
round to the same int8 code except where a value lies on a rounding
boundary, and one code apart (a step of 1/127 of the block's amax) moves
the vector by up to ~1e-4 on these models. Those cases hold the written
codes instead (every code within one of the reference's, fewer than 1% of
them off by one) and the vectors within 1e-3. The temporary pages are
released and never enter the prefix cache (tests/test_torch_embed_engine.py
holds the kernel wrappers, the capacity error and an embedding between
decode steps).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.__main__ import PRESETS as JPRESETS
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.models.registry import PRESETS as TPRESETS
from dynamo_tpu_torch.runtime import Context

TOL = 1e-5
# a chunked embedding on an int8 cache: codes one apart at rounding
# boundaries (see the module docstring)
INT8_CHUNKED_TOL = 1e-3
ENGINE = dict(num_blocks=64, block_size=4, max_batch_size=2, max_context=128,
              prefill_buckets=(16, 32), seed=0)
SHORT = np.random.default_rng(1).integers(0, 512, size=10).tolist()
LONG = np.random.default_rng(2).integers(0, 512, size=70).tolist()
# family preset -> the wrapper its attention must reach
KERNEL = {"tiny": "flash", "tiny-moe": "flash", "tiny-gemma3": "unified",
          "tiny-gptoss": "unified", "tiny-mla": "latent"}
CASES = [(p, kv) for p in KERNEL for kv in ("model", "int8") if not (p == "tiny-mla"
                                                                       and kv == "int8")]


def _configs(preset):
    jcfg = dataclasses.replace(JPRESETS[preset](), dtype=jnp.float32)
    tproto = TPRESETS[preset]()
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    return jcfg, type(tproto)(**dict(fields, dtype=torch.float32))


def _embed_req(cls, rid, tokens):
    return cls(request_id=rid, model="m", token_ids=list(tokens), annotations={"op": "embed"})


async def _embed(engine, req, ctx):
    outs = [o async for o in engine.generate(req, ctx)]
    assert len(outs) == 1 and outs[0].finish_reason == "stop"
    return outs[0].annotations


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def vectors(request):
    preset, kv = request.param
    jcfg, tcfg = _configs(preset)

    async def main():
        jeng = TpuEngine(TpuEngineConfig(model=jcfg, use_pallas=False, kv_dtype=kv, **ENGINE),
                         mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        tree = jax.tree.map(np.asarray, jeng.params)
        teng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", kv_dtype=kv,
                                             decode_steps=1, decode_pipeline=1, **ENGINE),
                           params=params_from_numpy(tree, tcfg, device="cpu"))
        try:
            want = [await _embed(jeng, _embed_req(JRequest, "e", t), JContext())
                    for t in (SHORT, LONG)]
            free = teng.allocator.free_blocks
            got = [await _embed(teng, _embed_req(PreprocessedRequest, "e", t), Context())
                   for t in (SHORT, LONG)]
            state = {"free_before": free, "free_after": teng.allocator.free_blocks,
                     "cached": teng.allocator.cached_blocks,
                     "hashes": len(teng.allocator._by_hash),
                     "steps": dict(teng.step_counts), "kv": kv, "codes": None}
            if kv == "int8":
                # the temporary pages still hold what the last embedding wrote
                pairs = [(np.asarray(j.data), t.data.numpy())
                         for j, t in zip(jeng.k_caches + jeng.v_caches,
                                         teng.k_caches + teng.v_caches)]
                diff = np.concatenate([np.abs(j.astype(int) - t.astype(int)).ravel()
                                       for j, t in pairs])
                written = sum(int((j != 0).sum()) for j, _ in pairs)
                state["codes"] = (int(diff.max()), int((diff > 0).sum()), written)
        finally:
            jeng.stop()
            teng.stop()
        return want, got, state

    return asyncio.run(main())


@pytest.mark.parametrize("which", ["short", "chunked"])
def test_embedding_equals_tpu_engine(vectors, which):
    want, got, _ = vectors
    i = ("short", "chunked").index(which)
    w, g = np.asarray(want[i]["embedding"]), np.asarray(got[i]["embedding"])
    assert g.dtype == np.float64 and g.shape == w.shape
    assert abs(np.linalg.norm(g) - 1.0) < 1e-5
    tol = INT8_CHUNKED_TOL if (which, vectors[2]["kv"]) == ("chunked", "int8") else TOL
    assert np.max(np.abs(g - w)) < tol, np.max(np.abs(g - w))
    assert got[i]["input_tokens"] == want[i]["input_tokens"] == len((SHORT, LONG)[i])


def test_int8_pages_hold_the_reference_codes(vectors):
    """A chunked embedding's int8 pages: every code within one of the
    reference's, fewer than 1% of the written codes off by one."""
    codes = vectors[2]["codes"]
    if codes is None:
        assert vectors[2]["kv"] == "model"
        return
    worst, off, written = codes
    assert written > 0 and worst <= 1 and off < 0.01 * written, codes


def test_temporary_pages_are_released_and_never_cached(vectors):
    _, _, state = vectors
    assert state["free_after"] == state["free_before"]
    assert state["cached"] == 0 and state["hashes"] == 0
    # one forward for the short input, three chunks for the long one
    assert state["steps"]["embed"] == 4
    assert state["steps"]["prefill"] == 0
