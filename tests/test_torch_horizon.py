"""The port's decode horizon (TorchEngine ``decode_steps`` > 1, on the CPU:
the eager horizon body) against TpuEngine's ``decode_multi`` on the same
tiny float32 models and weights.

Both engines run ``decode_steps=4`` with ``decode_pipeline`` 1 and 2 (the
JAX engine with ``use_pallas=False, mixed_admission=True``, as
tests/test_torch_engine.py runs it): greedy streams, cached tokens and
finish reasons must be IDENTICAL in tests/test_torch_engine.py's
scenarios plus a request of 13 tokens (not a horizon multiple); a seeded
sampled stream equals TpuEngine's and the port's own ``decode_steps=1``
stream; a request with penalties and 5 top logprobs streams TpuEngine's
tokens, its logprobs within 1e-5 (float32 logits of two frameworks). Also
the reference's own horizon scenarios (tests/test_engine.py), a tiny
Gemma 2 behind a horizon against TpuEngine, and an int8 + KVBM engine
whose offloaded decode-sealed blocks must equal their device blocks after
the write, bit for bit.
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
from dynamo_tpu_torch.kvbm import layout as tl
from dynamo_tpu_torch.kvbm import pool as tp
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from test_torch_engine import ENGINE, MODEL, Side, _prompt, _scenarios

LOGPROB_TOL = 1e-5
HORIZON = dict(ENGINE, decode_steps=4)
SAMPLED = dict(temperature=0.8, top_p=0.95, seed=7)
PENALIZED = dict(temperature=0.0, presence_penalty=0.5, frequency_penalty=0.3,
                 repetition_penalty=1.2, logprobs=5)


async def _run(side: Side, rid, tokens, max_tokens, **sampling):
    """One request's tokens, logprobs, top logprobs, cached tokens and
    finish reason."""
    req = side.req(request_id=rid, model="m", token_ids=list(tokens),
                   stop=side.stop(max_tokens=max_tokens), sampling=side.samp(**sampling))
    out = {"tokens": [], "logprobs": [], "top": [], "cached": None, "finish": None}
    async for item in side.engine.generate(req, side.ctx()):
        out["tokens"].extend(item.token_ids)
        out["logprobs"].extend(item.logprobs or [])
        out["top"].extend(item.top_logprobs or [])
        if "cached_tokens" in (item.annotations or {}):
            out["cached"] = item.annotations["cached_tokens"]
        out["finish"] = item.finish_reason or out["finish"]
    return out


async def _horizon_scenarios(side: Side):
    out = await _scenarios(side)
    out["odd"] = await side.run("odd", _prompt(21, 17), max_tokens=13)
    out["sampled"] = await _run(side, "sampled", _prompt(22, 30), 14, **SAMPLED)
    out["penalized"] = await _run(side, "penalized", _prompt(23, 12), 11, **PENALIZED)
    return out


def _weights():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **MODEL)
    jparams = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    return jcfg, jparams, tcfg, jax.tree.map(np.asarray, jparams)


def _torch_side(tcfg, tree, **cfg):
    engine = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", **cfg),
                         params=params_from_numpy(tree, tcfg, device="cpu"))
    return Side(engine, PreprocessedRequest, SamplingOptions, StopConditions, Context)


@pytest.fixture(scope="module", params=[1, 2], ids=["pipeline1", "pipeline2"])
def streams(request):
    jcfg, jparams, tcfg, tree = _weights()
    cfg = dict(HORIZON, decode_pipeline=request.param)

    async def main():
        jside = Side(TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True, **cfg),
            params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]),
        ), JRequest, JSampling, JStop, JContext)
        tside = _torch_side(tcfg, tree, **cfg)
        single = _torch_side(tcfg, tree, **ENGINE)
        try:
            want = await _horizon_scenarios(jside)
            got = await _horizon_scenarios(tside)
            got["sampled_single_step"] = await _run(single, "sampled", _prompt(22, 30), 14,
                                                    **SAMPLED)
        finally:
            for side in (jside, tside, single):
                side.engine.stop()
        return want, got, dict(tside.engine.step_counts)

    return asyncio.run(main())


def test_horizon_single_and_odd_streams_equal_tpu_engine(streams):
    want, got, steps = streams
    assert steps["horizon"] > 0, steps
    assert got["single"]["tokens"] == want["single"]["tokens"]
    assert len(got["single"]["tokens"]) == 8
    assert got["odd"]["tokens"] == want["odd"]["tokens"]
    assert len(got["odd"]["tokens"]) == 13
    assert got["odd"]["finish"] == "length" == want["odd"]["finish"]


def test_horizon_chunked_and_repeat_streams_equal_tpu_engine(streams):
    want, got, _ = streams
    assert got["chunked"]["tokens"] == want["chunked"]["tokens"]
    assert len(got["chunked"]["tokens"]) == 6
    for key in ("first", "second"):
        assert got["repeat"][key]["tokens"] == want["repeat"][key]["tokens"]
        assert got["repeat"][key]["cached"] == want["repeat"][key]["cached"]
    assert got["repeat"]["second"]["cached"] > 0


def test_horizon_staggered_streams_equal_tpu_engine(streams):
    want, got, steps = streams
    assert steps["mixed"] > 0, steps
    assert [r["tokens"] for r in got["staggered"]] == [r["tokens"] for r in want["staggered"]]
    assert [r["finish"] for r in got["staggered"]] == [r["finish"] for r in want["staggered"]]
    assert [len(r["tokens"]) for r in got["staggered"]] == [24, 10, 12, 5]


def test_horizon_stop_token_equals_tpu_engine(streams):
    want, got, _ = streams
    assert got["stop"]["stop_token"] == want["stop"]["stop_token"]
    stopped = got["stop"]["stopped"]
    assert stopped["tokens"] == want["stop"]["stopped"]["tokens"]
    assert stopped["finish"] == "stop" == want["stop"]["stopped"]["finish"]
    cut = got["stop"]["free"]["tokens"].index(got["stop"]["stop_token"])
    assert stopped["tokens"] == got["stop"]["free"]["tokens"][:cut]


def test_horizon_seeded_sampled_stream(streams):
    """Sampled at steps0 + s inside the horizon: the same stream as the
    port's one-step decode and TpuEngine's horizon."""
    want, got, _ = streams
    assert len(got["sampled"]["tokens"]) == 14
    assert got["sampled"]["tokens"] == want["sampled"]["tokens"]
    assert got["sampled"]["tokens"] == got["sampled_single_step"]["tokens"]
    np.testing.assert_allclose(got["sampled"]["logprobs"], want["sampled"]["logprobs"],
                               rtol=0, atol=LOGPROB_TOL)


def test_horizon_penalties_and_logprobs(streams):
    want, got, _ = streams
    g, w = got["penalized"], want["penalized"]
    assert g["tokens"] == w["tokens"] and len(g["tokens"]) == 11
    np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=0, atol=LOGPROB_TOL)
    assert len(g["top"]) == len(w["top"]) == 11
    for gt, wt in zip(g["top"], w["top"]):
        assert len(gt) == 5 and set(gt) == set(wt)
        for tok, lp in gt.items():
            assert abs(lp - wt[tok]) <= LOGPROB_TOL


# ---------------------------------------------- the reference's scenarios
def _tiny_engine(**kw):
    """tests/test_engine.py's tiny engine, with the port's own weights."""
    cfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    defaults = dict(num_blocks=64, block_size=4, max_batch_size=4, max_context=256,
                    prefill_buckets=(16, 32, 64, 128, 256), device="cpu",
                    decode_pipeline=1)
    return TorchEngine(TorchEngineConfig(model=cfg, **{**defaults, **kw}))


def _greedy(rid, tokens, max_tokens=8, stop_ids=()):
    return PreprocessedRequest(
        request_id=rid, model="m", token_ids=tokens,
        stop=StopConditions(max_tokens=max_tokens, ignore_eos=True,
                            stop_token_ids=list(stop_ids)),
        sampling=SamplingOptions(temperature=0.0))


async def _tokens(engine, req):
    toks = []
    async for out in engine.generate(req, Context()):
        toks.extend(out.token_ids)
    return toks


async def test_multi_step_decode_equivalence():
    """decode_steps > 1 streams exactly the one-step decode's tokens (as
    tests/test_engine.py's test of the same name)."""
    prompt = list(range(10, 30))
    e1 = _tiny_engine(decode_steps=1)
    try:
        ref = await _tokens(e1, _greedy("a", prompt, max_tokens=13))
    finally:
        e1.stop()
    e2 = _tiny_engine(decode_steps=4)   # 13 tokens: not a horizon multiple
    try:
        got = await _tokens(e2, _greedy("b", prompt, max_tokens=13))
        assert e2.step_counts["horizon"] > 0
    finally:
        e2.stop()
    assert len(ref) == 13
    assert got == ref


async def test_multi_step_stop_token_mid_horizon():
    """A stop token sampled mid-horizon trims the speculated tail."""
    engine = _tiny_engine(decode_steps=8)
    try:
        prompt = list(range(30, 50))
        probe = await _tokens(engine, _greedy("p", prompt, max_tokens=8))
        stop_tok = probe[2]
        toks = await _tokens(engine, _greedy("s", prompt, max_tokens=8, stop_ids=[stop_tok]))
        assert toks == probe[:probe.index(stop_tok)]
    finally:
        engine.stop()


# --------------------------------------------------------------- gemma
async def test_gemma2_horizon_stream_equals_tpu_engine():
    """tiny_gemma2 (window 16, attention and final softcaps) behind a
    horizon of 4 on both engines: greedy streams identical."""
    from dynamo_tpu.models import gemma as jgemma
    from dynamo_tpu_torch.models import gemma as tgemma
    from test_torch_gemma import _numpy_params

    jcfg, tcfg = jgemma.GemmaConfig.tiny_gemma2(), tgemma.GemmaConfig.tiny_gemma2()
    tree = _numpy_params(jcfg, seed=5)
    jside = Side(TpuEngine(
        TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True, **HORIZON),
        params=jax.tree.map(jnp.asarray, tree),
        mesh=make_mesh(tp=1, devices=jax.devices()[:1])), JRequest, JSampling, JStop, JContext)
    tside = _torch_side(tcfg, tree, **HORIZON)

    async def scenario(side):
        started = asyncio.Event()
        lead = asyncio.ensure_future(side.run("lead", _prompt(2, 20), 22, on_first=started))
        await started.wait()
        rest = await side.run("b", _prompt(3, 40), 9)
        return [(await lead)["tokens"], rest["tokens"]]

    try:
        want = await scenario(jside)
        got = await scenario(tside)
        assert tside.engine.step_counts["horizon"] > 0
    finally:
        jside.engine.stop()
        tside.engine.stop()
    assert [len(t) for t in got] == [22, 9]
    assert got == want


# ---------------------------------------------------------- int8 + KVBM
@pytest.mark.parametrize("pipeline", [1, 2])
async def test_int8_kvbm_horizon_offloads_written_blocks_only(pipeline):
    """Every block an int8 + KVBM engine offloads while decoding in
    horizons of 4 equals its device block after the write, payload and
    scales bit for bit. Blocks hold 4 tokens and each prompt's first
    output token makes a multiple of 4, so the last token of every horizon
    seals a block whose last row only the next horizon writes."""
    mcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    codec = tl.QuantizedBlockCodec(tl.block_shape_for(mcfg, 4, "int8"))
    kvbm = tp.KvbmTiers(codec.nbytes, host_capacity_bytes=256 * codec.nbytes)
    engine = TorchEngine(TorchEngineConfig(
        model=mcfg, device="cpu", num_blocks=128, block_size=4, max_batch_size=2,
        max_context=128, prefill_buckets=(16, 32, 64), kv_dtype="int8",
        decode_steps=4, decode_pipeline=pipeline), kvbm=kvbm)
    prompts = [_prompt(31, 23), _prompt(32, 19)]
    try:
        side = Side(engine, PreprocessedRequest, SamplingOptions, StopConditions, Context)
        runs = [await side.run(f"r{i}", p, max_tokens=26) for i, p in enumerate(prompts)]
        await engine.flush_offload()
        assert engine.step_counts["horizon"] > 0 and engine.offload_errors == 0
        checked = 0
        for prompt, run in zip(prompts, runs):
            # the last token is never fed back: blocks of prompt + the rest
            hashes = compute_sequence_hashes(prompt + run["tokens"][:-1], 4)
            ids = engine.allocator.match_prefix(hashes)
            assert len(ids) == len(hashes)
            for i in range(len(prompt) // 4, len(hashes)):   # decode-sealed blocks
                stored = kvbm.host.get(hashes[i])
                assert stored is not None, f"decode-sealed block {i} never offloaded"
                pay, scl = codec.decode(np.asarray(stored))
                for li, (kc, vc) in enumerate(zip(engine.k_caches, engine.v_caches)):
                    for kv, c in ((0, kc), (1, vc)):
                        np.testing.assert_array_equal(c.data[ids[i]].numpy(), pay[li, kv])
                        np.testing.assert_array_equal(c.scale[ids[i]].numpy(), scl[li, kv])
                checked += 1
        assert checked >= 10
    finally:
        engine.stop()
