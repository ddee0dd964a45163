"""The port's int8 KV cache and KVBM tiers end to end: TorchEngine(kv_dtype=
"int8", device="cpu") against TpuEngine(kv_dtype="int8") on the same tiny
float32 model and the same weights, in the setting of
tests/test_kv_quant.py's engine tests.

Greedy streams must be IDENTICAL (chunked prefill, a fused mixed step and
decode all read the quantized cache), a seeded SAMPLED request must stream
the same tokens on both engines (the port draws JAX's threefry noise), and
the KVBM scenario of tests/test_kv_quant.py runs on the port: offload,
churn, onboard, the same greedy stream, cached tokens, and an onboarded
block that re-encodes bit-exactly to its stored host bytes. Each engine is
built once per module.
"""

import asyncio

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
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kvbm.layout import QuantizedBlockCodec, block_shape_for
from dynamo_tpu_torch.kvbm.pool import KvbmTiers
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.tokens import compute_sequence_hashes

MODEL = dict(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128,
)
# tests/test_kv_quant.py's engine: block 4, two slots, buckets up to 64
ENGINE = dict(block_size=4, max_batch_size=2, max_context=128,
              prefill_buckets=(16, 32, 64), seed=0, kv_dtype="int8",
              decode_steps=1, decode_pipeline=1)
PROMPTS = [
    [(i * 37 + 11) % 500 for i in range(9)],
    [(i * 13 + 5) % 500 for i in range(21)],
]
LONG = [(i * 7 + 3) % 500 for i in range(90)]     # two chunks of a 64 bucket
PROMPT_A = list(range(100, 124))                 # 24 tokens = 6 blocks


def _side(engine, req_cls, samp_cls, stop_cls, ctx_cls):
    async def run(rid, tokens, n=6, **samp):
        req = req_cls(request_id=rid, model="m", token_ids=list(tokens),
                      stop=stop_cls(max_tokens=n, ignore_eos=True),
                      sampling=samp_cls(**({"temperature": 0.0} | samp)))
        toks, cached = [], None
        async for out in engine.generate(req, ctx_cls()):
            toks.extend(out.token_ids)
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
        return toks, cached
    return run


async def _scenarios(run):
    out = {"greedy": [(await run(f"g{i}", p))[0] for i, p in enumerate(PROMPTS)]}
    # a resident decode beside a chunked prefill: the fused mixed step
    out["staggered"] = [t for t, _ in await asyncio.gather(
        run("lead", PROMPTS[0], n=20), run("long", LONG, n=5))]
    out["sampled"] = (await run("s", PROMPTS[1], n=10, temperature=0.8, top_p=0.95,
                                seed=7))[0]
    out["prompt_a"] = (await run("a", PROMPT_A))[0]
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **MODEL)
    jparams = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    return jcfg, jparams, tcfg, jax.tree.map(np.asarray, jparams)


def _torch_engine(weights, num_blocks=32, kvbm=None):
    _, _, tcfg, tree = weights
    return TorchEngine(
        TorchEngineConfig(model=tcfg, device="cpu", num_blocks=num_blocks, **ENGINE),
        params=params_from_numpy(tree, tcfg, device="cpu"), kvbm=kvbm,
    )


@pytest.fixture(scope="module")
def streams(weights):
    jcfg, jparams, _, _ = weights

    async def main():
        jeng = TpuEngine(
            TpuEngineConfig(model=jcfg, num_blocks=32, use_pallas=False,
                            mixed_admission=True, **ENGINE),
            params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]),
        )
        teng = _torch_engine(weights)
        try:
            want = await _scenarios(_side(jeng, JRequest, JSampling, JStop, JContext))
            got = await _scenarios(_side(teng, PreprocessedRequest, SamplingOptions,
                                         StopConditions, Context))
        finally:
            jeng.stop()
            teng.stop()
        return want, got, dict(teng.step_counts)

    return asyncio.run(main())


def test_engine_int8_caches_are_quantized(weights):
    eng = _torch_engine(weights)
    try:
        kc = eng.k_caches[0]
        assert kc.data.dtype == torch.int8 and kc.scale.dtype == torch.float32
        assert tuple(kc.scale.shape) == (32, MODEL["num_kv_heads"])
    finally:
        eng.stop()


def test_greedy_streams_equal_tpu_engine_int8(streams):
    want, got, _ = streams
    assert got["greedy"] == want["greedy"]
    assert [len(t) for t in got["greedy"]] == [6, 6]


def test_mixed_step_streams_equal_tpu_engine_int8(streams):
    want, got, steps = streams
    assert steps["mixed"] > 0, steps
    assert got["staggered"] == want["staggered"]


def test_seeded_sampled_stream_equals_tpu_engine(streams):
    """The seeded-sampling repair: the port's Gumbel noise is JAX's."""
    want, got, _ = streams
    assert len(got["sampled"]) == 10
    assert got["sampled"] == want["sampled"]


async def test_kvbm_offload_onboard_bit_exact(weights, streams):
    """tests/test_kv_quant.py's KVBM scenario on the port: offloaded int8
    blocks are the flat codec buffer; after device eviction the onboard path
    scatters them back bit-exactly and the greedy stream is unchanged (and
    equals the JAX int8 engine's)."""
    codec = QuantizedBlockCodec(block_shape_for(weights[2], 4, "int8"))
    kvbm = KvbmTiers(codec.nbytes, host_capacity_bytes=64 * codec.nbytes)
    e = _torch_engine(weights, num_blocks=14, kvbm=kvbm)
    run = _side(e, PreprocessedRequest, SamplingOptions, StopConditions, Context)
    try:
        t1, _ = await run("a", PROMPT_A)
        await e.flush_offload()
        assert t1 == streams[0]["prompt_a"]
        assert kvbm.stats()["offloaded"] >= 6
        h0 = compute_sequence_hashes(PROMPT_A, 4)[0]
        stored0 = kvbm.host.get(h0)
        assert stored0 is not None and stored0.dtype == np.uint8
        assert stored0.nbytes == codec.nbytes
        stored0 = stored0.copy()
        for i in range(4):    # churn the 13 usable device blocks
            await run(f"c{i}", list(range(200 + 30 * i, 224 + 30 * i)))
        assert not e.allocator.match_prefix([h0])
        t2, cached2 = await run("a2", PROMPT_A)
        assert t2 == t1
        assert cached2 and cached2 > 0
        assert kvbm.stats()["onboarded"] > 0
        (bid,) = e.allocator.match_prefix([h0])
        pay = np.empty(codec.payload_shape, np.int8)
        scl = np.empty(codec.scales_shape, np.float32)
        for li, (kc, vc) in enumerate(zip(e.k_caches, e.v_caches)):
            pay[li, 0], pay[li, 1] = kc.data[bid].numpy(), vc.data[bid].numpy()
            scl[li, 0], scl[li, 1] = kc.scale[bid].numpy(), vc.scale[bid].numpy()
        np.testing.assert_array_equal(codec.encode(pay, scl), stored0)
        assert e.offload_errors == 0 and kvbm.stats()["errors"] == 0
    finally:
        e.stop()


async def test_foreign_tier_blocks_are_a_miss(weights):
    """A tier block of another format under the same content hash (a float
    block met by an int8 engine) is skipped, never imported."""
    kvbm = KvbmTiers(64, host_capacity_bytes=1 << 20)
    prompt = list(range(300, 320))
    for h in compute_sequence_hashes(prompt, 4):
        kvbm.store(h, np.zeros((2, 2, 4, 2, 16), np.float32))
    e = _torch_engine(weights, kvbm=kvbm)
    run = _side(e, PreprocessedRequest, SamplingOptions, StopConditions, Context)
    try:
        toks, cached = await run("f", prompt, n=3)
        assert len(toks) == 3 and cached == 0
    finally:
        e.stop()
