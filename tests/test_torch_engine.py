"""The port's serving slice as a whole: TorchEngine (on the CPU, plain ops)
against TpuEngine on the same tiny float32 model and the same weights.

Setup as tests/test_engine.py's tiny engine; both engines run the fused
mixed step (TorchEngine always does; TpuEngine opts in with
mixed_admission=True, since tests/conftest.py defaults DTPU_MIXED to
off). Greedy token streams must be IDENTICAL for every scenario. Both
engines serve every scenario in one event loop built once per module (each
TpuEngine compiles its programs on first use), and each scenario is then
its own test.
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
from dynamo_tpu_torch.engine.engine import (
    TorchEngine,
    TorchEngineConfig,
    UnsupportedRequestError,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import Context

MODEL = dict(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128,
)
# largest bucket 64: a 150-token prompt prefills in three chunks
ENGINE = dict(
    num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
    prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1,
)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


LONG = _prompt(11, 150)
REPEAT = _prompt(12, 41)
STOP_PROMPT = _prompt(13, 23)


class Side:
    """One engine behind the scenarios, with its package's request types."""

    def __init__(self, engine, req_cls, samp_cls, stop_cls, ctx_cls):
        self.engine = engine
        self.req, self.samp, self.stop, self.ctx = req_cls, samp_cls, stop_cls, ctx_cls

    async def run(self, rid, tokens, max_tokens=8, stop_ids=(), on_first=None):
        req = self.req(
            request_id=rid, model="m", token_ids=list(tokens),
            stop=self.stop(max_tokens=max_tokens, stop_token_ids=list(stop_ids)),
            sampling=self.samp(temperature=0.0),
        )
        toks, cached, finish = [], None, None
        async for out in self.engine.generate(req, self.ctx()):
            toks.extend(out.token_ids)
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
            if toks and on_first is not None and not on_first.is_set():
                on_first.set()
            finish = out.finish_reason or finish
        return {"tokens": toks, "cached": cached, "finish": finish}


async def _scenarios(side: Side):
    out = {}
    out["single"] = await side.run("single", _prompt(1, 20))
    out["chunked"] = await side.run("chunked", LONG, max_tokens=6)
    first = await side.run("repeat-a", REPEAT)
    second = await side.run("repeat-b", REPEAT)
    out["repeat"] = {"first": first, "second": second}
    # staggered: a resident decode, then prompts that prefill (in chunks)
    # while it and each other decode
    started = asyncio.Event()
    lead = asyncio.ensure_future(
        side.run("lead", _prompt(2, 9), max_tokens=24, on_first=started)
    )
    await started.wait()
    rest = await asyncio.gather(
        side.run("b", _prompt(3, 70), max_tokens=10),
        side.run("c", _prompt(4, 33), max_tokens=12),
        side.run("d", _prompt(5, 130), max_tokens=5),
    )
    out["staggered"] = [await lead] + list(rest)
    free = await side.run("stop-free", STOP_PROMPT, max_tokens=12)
    stop_tok = free["tokens"][4]
    out["stop"] = {
        "free": free,
        "stopped": await side.run("stop", STOP_PROMPT, max_tokens=12,
                                  stop_ids=[stop_tok]),
        "stop_token": stop_tok,
    }
    return out


@pytest.fixture(scope="module")
def streams():
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **MODEL)
    jparams = jllama.init_params(jax.random.PRNGKey(5), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)

    async def main():
        jeng = TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, mixed_admission=True, **ENGINE),
            params=jparams, mesh=make_mesh(tp=1, devices=jax.devices()[:1]),
        )
        teng = TorchEngine(
            TorchEngineConfig(model=tcfg, device="cpu", **ENGINE),
            params=params_from_numpy(tree, tcfg, device="cpu"),
        )
        try:
            want = await _scenarios(Side(jeng, JRequest, JSampling, JStop, JContext))
            got = await _scenarios(Side(teng, PreprocessedRequest, SamplingOptions,
                                        StopConditions, Context))
        finally:
            jeng.stop()
            teng.stop()
        return want, got, dict(teng.step_counts)

    return asyncio.run(main())


def test_single_request_stream_equals_tpu_engine(streams):
    want, got, _ = streams
    assert len(got["single"]["tokens"]) == 8
    assert got["single"]["tokens"] == want["single"]["tokens"]


def test_chunked_prefill_stream_equals_tpu_engine(streams):
    """150 prompt tokens over a largest bucket of 64: three chunks."""
    want, got, _ = streams
    assert got["chunked"]["tokens"] == want["chunked"]["tokens"]
    assert len(got["chunked"]["tokens"]) == 6


def test_repeated_prompt_hits_the_prefix_cache(streams):
    want, got, _ = streams
    assert got["repeat"]["first"]["cached"] == 0
    assert got["repeat"]["second"]["cached"] > 0
    assert got["repeat"]["second"]["cached"] == want["repeat"]["second"]["cached"]
    assert got["repeat"]["second"]["tokens"] == got["repeat"]["first"]["tokens"]
    assert got["repeat"]["second"]["tokens"] == want["repeat"]["second"]["tokens"]


def test_staggered_concurrent_streams_equal_tpu_engine(streams):
    want, got, steps = streams
    assert steps["mixed"] > 0, steps
    assert [r["tokens"] for r in got["staggered"]] == [
        r["tokens"] for r in want["staggered"]
    ]
    assert [len(r["tokens"]) for r in got["staggered"]] == [24, 10, 12, 5]


def test_stop_token_and_max_tokens_equal_tpu_engine(streams):
    want, got, _ = streams
    assert got["stop"]["stop_token"] == want["stop"]["stop_token"]
    stopped, free = got["stop"]["stopped"], got["stop"]["free"]
    assert stopped["tokens"] == want["stop"]["stopped"]["tokens"]
    assert stopped["finish"] == "stop" == want["stop"]["stopped"]["finish"]
    cut = free["tokens"].index(got["stop"]["stop_token"])
    assert stopped["tokens"] == free["tokens"][:cut]
    assert free["finish"] == "length" == want["stop"]["free"]["finish"]
    assert len(free["tokens"]) == 12


def _tiny_engine(**kw):
    cfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    return TorchEngine(TorchEngineConfig(model=cfg, device="cpu", **{**ENGINE, **kw}))


async def test_unsupported_options_are_refused():
    engine = _tiny_engine()
    try:
        for ann, samp in (({"lora": "a"}, {}), ({"logits_processors": ["x"]}, {}),
                          ({"op": "embed", "images": [{}]}, {}),
                          ({}, {"guided": {"kind": "regex"}})):
            req = PreprocessedRequest(
                request_id="x", model="m", token_ids=[1, 2, 3], annotations=ann,
                sampling=SamplingOptions(temperature=0.0, **samp),
            )
            with pytest.raises(UnsupportedRequestError):
                async for _ in engine.generate(req, Context()):
                    pass
        too_long = PreprocessedRequest(request_id="y", model="m", token_ids=[1] * 300)
        with pytest.raises(ValueError, match="max_context"):
            async for _ in engine.generate(too_long, Context()):
                pass
    finally:
        engine.stop()


async def test_cancelled_request_finishes_and_frees_its_blocks():
    engine = _tiny_engine()
    try:
        free_before = engine.allocator.free_blocks
        ctx = Context()
        req = PreprocessedRequest(
            request_id="c", model="m", token_ids=_prompt(6, 30),
            stop=StopConditions(max_tokens=200), sampling=SamplingOptions(temperature=0.0),
        )
        outs = []
        async for out in engine.generate(req, ctx):
            outs.append(out)
            if len(outs) == 3:
                ctx.stop_generating()
        assert outs[-1].finish_reason == "cancelled"
        assert len(outs) < 10
        for _ in range(20):
            if all(s is None for s in engine._slots):
                break
            await asyncio.sleep(0.01)
        # the prompt's sealed blocks stay cached (evictable), nothing leaks
        assert engine.allocator.free_blocks == free_before
    finally:
        engine.stop()


async def test_seeded_sampled_stream_reproduces():
    """A seeded sampled request yields the same stream alone and beside
    other requests (per-row noise keyed by (seed, step))."""
    engine = _tiny_engine()

    async def run(rid, tokens, temp, seed):
        req = PreprocessedRequest(
            request_id=rid, model="m", token_ids=tokens,
            stop=StopConditions(max_tokens=10),
            sampling=SamplingOptions(temperature=temp, top_k=50, seed=seed),
        )
        toks = []
        async for out in engine.generate(req, Context()):
            toks.extend(out.token_ids)
        return toks

    try:
        alone = await run("a", _prompt(7, 20), 1.0, 1234)
        together = await asyncio.gather(
            run("b", _prompt(8, 37), 0.0, None),
            run("c", _prompt(7, 20), 1.0, 1234),
            run("d", _prompt(9, 12), 0.8, 99),
        )
        assert together[1] == alone
        assert len(alone) == 10
    finally:
        engine.stop()


def test_run_cli_serves_a_prompt_on_the_cpu(tmp_path):
    """python -m dynamo_tpu_torch.run drives TorchEngine through the byte
    tokenizer: a text prompt streams text, a batch file gives JSON lines."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    common = ["out=tiny", "--device", "cpu", "--max-tokens", "4", "--max-context", "256"]
    env = {**os.environ, "PYTHONPATH": repo}
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hello",
                        *common], cwd=repo, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip()
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("abc\n\nxyz\n")
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run",
                        f"in=batch:{prompts}", *common], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = [json.loads(line) for line in r.stdout.splitlines()]
    assert [(d["index"], d["prompt"]) for d in lines] == [(0, "abc"), (1, "xyz")]
